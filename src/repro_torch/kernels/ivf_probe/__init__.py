from repro_torch.kernels.ivf_probe.ops import (MAX_LANES, ivf_probe_stream,
                                               ivf_probe_stream_batch,
                                               ivf_probe_topk,
                                               ivf_probe_topk_batch)
from repro_torch.kernels.ivf_probe.ref import (batch_probe_slots,
                                               ivf_probe_stream_batch_ref,
                                               ivf_probe_stream_ref)

__all__ = [
    "MAX_LANES", "batch_probe_slots", "ivf_probe_stream",
    "ivf_probe_stream_batch", "ivf_probe_stream_batch_ref",
    "ivf_probe_stream_ref", "ivf_probe_topk", "ivf_probe_topk_batch",
]
