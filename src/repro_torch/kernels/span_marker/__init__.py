from repro_torch.kernels.span_marker.ops import span_marker, span_marker_cuda
from repro_torch.kernels.span_marker.ref import span_marker_ref

__all__ = ["span_marker", "span_marker_cuda", "span_marker_ref"]
