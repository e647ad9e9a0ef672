"""The measurement schema shared with the JAX package (record.py)."""
from repro_torch.measure.record import MeasurementRecord

__all__ = ["MeasurementRecord"]
