"""geopurify_tpu_torch.data."""
