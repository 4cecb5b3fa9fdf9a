"""geopurify_tpu_torch.ops."""
