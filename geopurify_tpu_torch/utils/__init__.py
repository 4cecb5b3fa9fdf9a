"""geopurify_tpu_torch.utils."""
