"""Device time per step of the kernels that build the candidate tensor
(ms): ``sensor.make_views_from_pooled``'s ``index_select`` of the pooled
columns into [B, R, L W], which PyTorch runs as its gather kernel, and the
strided copy that permutes that into the candidates f32[B, L, R W] (at
BASELINE config 4, 283 MB written by each a step).

The names are those the traced slice of exact_lib50_b1024 gave on an H100
(PyTorch 2.11, CUDA 12.8), 1.0 launch a step each:

- ``void at::native::_scatter_gather_elementwise_kernel<128, 8,
  at::native::_cuda_scatter_gather_internal_kernel<false,
  at::native::OpaqueType<4>, long>::operator()<at::native::TensorAssign>...``
  (0.175 ms a step; the episode's one other 4-byte gather, outside the
  step, adds one launch of microseconds an episode);
- ``void at::native::elementwise_kernel<128, 2,
  at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(
  at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}
  ::operator()() const::{lambda(float)#1}>...`` (0.252 ms a step); the
  step's contiguous float copies run ``unrolled_elementwise_kernel`` and are
  left out.

Writing the candidates once and reading the pooled panorama, 307 MB a step,
takes 0.092 ms at 3.35 TB/s: the floor for this reading."""

KERNELS = (r"_scatter_gather_elementwise_kernel<128, 8, "
           r"at::native::_cuda_scatter_gather_internal_kernel<false, at::native::OpaqueType<4>"
           r"|elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
           r"at::native::direct_copy_kernel_cuda\(.*\{lambda\(float\)#1\}")


def read(trace):
    t = trace.time_s(KERNELS)
    return t * 1e3 / trace.steps if t else None
