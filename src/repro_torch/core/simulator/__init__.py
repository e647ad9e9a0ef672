from repro_torch.core.simulator.devices import DEVICES, DeviceSpec
from repro_torch.core.simulator.gpu_model import (ALL_KERNELS, GpuDispatch,
                                                  dispatch_for, gpu_latency_us,
                                                  select_conv_kernel)
from repro_torch.core.simulator.cpu_model import cpu_latency_us
from repro_torch.core.simulator.measure import (measure_latency_us,
                                                true_latency_us)

__all__ = [
    "DEVICES", "DeviceSpec", "ALL_KERNELS", "GpuDispatch", "dispatch_for",
    "gpu_latency_us", "select_conv_kernel", "cpu_latency_us",
    "measure_latency_us", "true_latency_us",
]
