from repro_torch.kernels.gram.kernel import gram_cuda, launch_count, reset_launch_count
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.gram.ref import gram_ref

__all__ = ["gram", "gram_cuda", "gram_ref", "launch_count", "reset_launch_count"]
