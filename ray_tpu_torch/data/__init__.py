"""The port's data layer: the device feed of a host batch iterator."""

from ray_tpu_torch.data.feed import device_batches

__all__ = ["device_batches"]
