from blackstar_tpu_torch.ops.filters import bloom, box_blur, supersample

__all__ = ["bloom", "box_blur", "supersample"]
