"""geopurify_tpu_torch.models."""
