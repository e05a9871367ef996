// Greedy farthest-point sampling on Hopper (sm_90a).
//
// Replaces: act_tpu/ops/fps.py::_fps_kernel_batched (its pallas_call at
// fps.py:186) and, at start index 0, act_tpu/ops/fps.py::_fps_kernel.
//
// Bound: the S-step loop is sequential. Each step needs the whole cloud's
// running minimum before the next center is known, so the time is set by the
// latency of S block-wide (max, first index) reductions, not by bytes (the
// cloud is read from device memory once) nor by arithmetic (8 flops a point a
// step).
//
// Design: one thread block per cloud runs all S steps. Each thread keeps PPT
// points (coordinates and running minimum distance) in registers, so a step
// touches no memory besides a 32-entry shared scratch for the reduction. The
// reduction is warp shuffles, then one warp over the per-warp winners. Ties
// go to the smaller point index, matching the first-argmax of the plain
// version. The distance is (x-cx)^2 + (y-cy)^2 + (z-cz)^2 in f32 with
// rounded multiplies and adds (no FMA contraction), in that order, like
// fps.py:128. Only B blocks run: at B=32 the card's other 100 SMs idle.
#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int PPT>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ pts, const int* __restrict__ start,
           int* __restrict__ out, int n, int s_total) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const float* p = pts + (size_t)b * n * 3;
  int* o = out + (size_t)b * s_total;

  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ float s_c[3];

  float x[PPT], y[PPT], z[PPT], d[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = i * nt + tid;
    if (j < n) {
      x[i] = p[3 * j];
      y[i] = p[3 * j + 1];
      z[i] = p[3 * j + 2];
      d[i] = INFINITY;
    } else {  // padding: -1 never beats a real distance (>= 0)
      x[i] = y[i] = z[i] = 0.f;
      d[i] = -1.f;
    }
  }

  int cur = start[b];
  cur = cur < 0 ? 0 : (cur >= n ? n - 1 : cur);
  if (tid == 0) o[0] = cur;
  float cx = __ldg(p + 3 * cur);
  float cy = __ldg(p + 3 * cur + 1);
  float cz = __ldg(p + 3 * cur + 2);

  for (int s = 1; s < s_total; ++s) {
    float best = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float dx = __fsub_rn(x[i], cx);
      const float dy = __fsub_rn(y[i], cy);
      const float dz = __fsub_rn(z[i], cz);
      const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      d[i] = fminf(d[i], dd);
      if (d[i] > best) {  // j rises with i: strict > keeps the first max
        best = d[i];
        bi = i * nt + tid;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      take_max(best, bi, __shfl_down_sync(0xffffffffu, best, off),
               __shfl_down_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? s_val[lane] : -INFINITY;
      bi = lane < nwarps ? s_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take_max(best, bi, __shfl_down_sync(0xffffffffu, best, off),
                 __shfl_down_sync(0xffffffffu, bi, off));
      if (lane == 0) {
        o[s] = bi;
        s_c[0] = __ldg(p + 3 * bi);
        s_c[1] = __ldg(p + 3 * bi + 1);
        s_c[2] = __ldg(p + 3 * bi + 2);
      }
    }
    __syncthreads();
    cx = s_c[0];
    cy = s_c[1];
    cz = s_c[2];
  }
}

}  // namespace

extern "C" {

// pts (B, N, 3) f32, start (B,) int32, out (B, S) int32; all contiguous on
// the device; 1 <= N <= 16384 (16 points a thread in registers). Returns the
// cudaError_t of the launch.
int act_fps(const void* pts, const void* start, void* out, int b, int n, int s,
            void* stream) {
  int ppt = 1;
  while (ppt * 1024 < n) ppt *= 2;
  int threads = (n + ppt - 1) / ppt;
  threads = ((threads + 31) / 32) * 32;
  const dim3 grid(b), block(threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* P = static_cast<const float*>(pts);
  const int* S0 = static_cast<const int*>(start);
  int* O = static_cast<int*>(out);
  switch (ppt) {
    case 1: fps_kernel<1><<<grid, block, 0, st>>>(P, S0, O, n, s); break;
    case 2: fps_kernel<2><<<grid, block, 0, st>>>(P, S0, O, n, s); break;
    case 4: fps_kernel<4><<<grid, block, 0, st>>>(P, S0, O, n, s); break;
    case 8: fps_kernel<8><<<grid, block, 0, st>>>(P, S0, O, n, s); break;
    case 16: fps_kernel<16><<<grid, block, 0, st>>>(P, S0, O, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
