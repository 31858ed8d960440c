from repro_torch.kernels.ivf_probe.ops import ivf_probe_stream, ivf_probe_topk
from repro_torch.kernels.ivf_probe.ref import ivf_probe_stream_ref

__all__ = ["ivf_probe_stream", "ivf_probe_stream_ref", "ivf_probe_topk"]
