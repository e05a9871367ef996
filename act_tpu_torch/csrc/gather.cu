// Coordinate gather on Hopper (sm_90a).
//
// Replaces: act_tpu/ops/gather.py::_gather_kernel (its pallas_call at
// gather.py:65), the one-hot-matmul gather the TPU needed for narrow rows.
//
// Bound: bytes. The function reads the indices and the gathered rows and
// writes the output; it does no arithmetic.
//
// Design: one thread per output element out[b, s, c] = pts[b, idx[b, s], c],
// so neighbouring threads write neighbouring addresses; the ragged edge of
// the last block is masked. The copy is exact. An index outside [0, N)
// writes NaN instead of reading out of bounds.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void gather_kernel(const float* __restrict__ pts,
                              const int* __restrict__ idx,
                              float* __restrict__ out, long long total, int n,
                              int s, int c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long bs = t / c;
  const int ch = (int)(t - bs * c);
  const long long b = bs / s;
  const int i = __ldg(idx + bs);
  out[t] = (i >= 0 && i < n) ? __ldg(pts + ((b * n + i) * c + ch)) : NAN;
}

}  // namespace

extern "C" {

// pts (B, N, C) f32, idx (B, S) int32, out (B, S, C) f32; contiguous on the
// device. Returns the cudaError_t of the launch.
int act_gather(const void* pts, const void* idx, void* out, int b, int n, int s,
               int c, void* stream) {
  const long long total = (long long)b * s * c;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  gather_kernel<<<(unsigned)blocks, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(idx),
      static_cast<float*>(out), total, n, s, c);
  return static_cast<int>(cudaGetLastError());
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
