// Coordinate gather on Hopper (sm_90a).
//
// Replaces: act_tpu/ops/gather.py::_gather_kernel (its pallas_call at
// gather.py:65), the one-hot-matmul gather the TPU needed for narrow rows.
//
// Bound: bytes. The function reads the indices and the gathered rows and
// writes the output; it does no arithmetic. Rows of C = 3 floats are 12
// bytes, so each row read costs a 32-byte sector of L2 traffic and, within a
// warp's load, a cache line of its own: what the card moves is rows, not
// bytes. At the paths' sizes (at most a few MB) a launch's own cost and two
// dependent memory latencies (the indices, then the rows they pick) are most
// of the time.
//
// Design: out[b, s, c] = pts[b, idx[b, s], c]. The grid runs over (tile of
// S, cloud), so a thread finds its cloud in blockIdx.y and does no 64-bit
// division; C is a template parameter (3 on every path, any C <= 8 built).
// Two bodies, picked by ops/gather.py launch_geometry from the size and the
// alignment:
// - element: a thread an output element (32-bit index arithmetic, the
//   division by C a multiply). Its index load, row load and store form the
//   shortest chain, and consecutive lanes read the channels of one row; it
//   serves gathers of fewer than 2^16 points and every unaligned one.
// - tile: a warp 128 consecutive points of a cloud. Lane l reads indices
//   4l..4l+3 as one 16-byte load into shared memory; then each lane reads
//   4C output elements, lane-consecutive (l + 32k), each row load issued
//   before any store, so a warp's load touches ~11 rows instead of 32; the
//   results go through shared memory and out as C 16-byte stores a lane.
//   It needs S a multiple of 4 and 16-byte aligned index and output views
//   (checked here), and serves the large gathers (the Stage-I and Stage-II
//   neighbourhoods), where a thread an element issues too many warps.
// The copy is exact. An index outside [0, N) writes NaN instead of reading
// out of bounds.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kTile = 128;  // points a warp of the tile body

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
    gather_element(const float* __restrict__ pts, const int* __restrict__ idx,
                   float* __restrict__ out, int b, int n, int s) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // element of a cloud's output
  if (e >= s * C) return;
  const int p = e / C, c = e - p * C;
  for (long long cloud = blockIdx.y; cloud < b; cloud += gridDim.y) {
    const int j = __ldg(idx + cloud * s + p);
    out[cloud * s * C + e] = j >= 0 && j < n ? __ldg(pts + (cloud * n + j) * C + c) : NAN;
  }
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
    gather_tile(const float* __restrict__ pts, const int* __restrict__ idx,
                float* __restrict__ out, int b, int n, int s) {
  __shared__ int4 sidx[kWarps][kTile / 4];
  __shared__ float4 sout[kWarps][kTile * C / 4];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int p0 = (blockIdx.x * (blockDim.x >> 5) + warp) * kTile;  // the warp's first point
  if (p0 >= s) return;  // the whole warp
  const int cnt = min(kTile, s - p0);  // a multiple of 4, as S is
  const int* si = reinterpret_cast<const int*>(sidx[warp]);
  float* so = reinterpret_cast<float*>(sout[warp]);
  for (long long cloud = blockIdx.y; cloud < b; cloud += gridDim.y) {
    const long long row = cloud * s + p0;
    const float* table = pts + cloud * n * C;
    if (4 * l < cnt) sidx[warp][l] = __ldg(reinterpret_cast<const int4*>(idx + row) + l);
    __syncwarp();
    float v[4 * C];
#pragma unroll
    for (int k = 0; k < 4 * C; ++k) {
      const int e = l + 32 * k, p = e / C;  // p < 128; past cnt its value is not stored
      const int j = si[p];
      v[k] = j >= 0 && j < n ? __ldg(table + static_cast<long long>(j) * C + (e - p * C)) : NAN;
    }
#pragma unroll
    for (int k = 0; k < 4 * C; ++k) so[l + 32 * k] = v[k];
    __syncwarp();
    float4* o = reinterpret_cast<float4*>(out + row * C);
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (4 * (l + 32 * q) < cnt * C) o[l + 32 * q] = sout[warp][l + 32 * q];
    __syncwarp();  // the next cloud's indices overwrite sidx
  }
}

template <int C>
cudaError_t launch_c(const float* pts, const int* idx, float* out, int b, int n, int s,
                     bool tile, int threads, cudaStream_t stream) {
  const unsigned clouds = b < 65535 ? b : 65535;
  if (tile) {
    const int warps = (s + kTile - 1) / kTile, per = threads / 32;
    gather_tile<C><<<dim3((warps + per - 1) / per, clouds), threads, 0, stream>>>(
        pts, idx, out, b, n, s);
  } else {
    gather_element<C><<<dim3((s * C + threads - 1) / threads, clouds), threads, 0, stream>>>(
        pts, idx, out, b, n, s);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pts (B, N, C) f32, idx (B, S) int32, out (B, S, C) f32; contiguous on the
// device, C in [1, 8]. tile: 1 for the tile body (S a multiple of 4, idx and
// out 16-byte aligned), 0 for the element body; threads a block in {32, 64,
// ..., 256} (ops/gather.py launch_geometry). Returns the cudaError_t of the
// launch.
int act_gather(const void* pts, const void* idx, void* out, int b, int n, int s, int c,
               int tile, int threads, void* stream) {
  const bool aligned = s % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0
                       && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (b < 0 || n < 0 || s < 0 || c < 1 || c > 8 || threads < 32 || threads > kMaxThreads
      || threads % 32 || s > INT_MAX / 8 - kMaxThreads || (tile && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return static_cast<int>(cudaSuccess);
  const float* p = static_cast<const float*>(pts);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool t = tile != 0;
  cudaError_t err;
  switch (c) {
    case 1: err = launch_c<1>(p, i, o, b, n, s, t, threads, st); break;
    case 2: err = launch_c<2>(p, i, o, b, n, s, t, threads, st); break;
    case 3: err = launch_c<3>(p, i, o, b, n, s, t, threads, st); break;
    case 4: err = launch_c<4>(p, i, o, b, n, s, t, threads, st); break;
    case 5: err = launch_c<5>(p, i, o, b, n, s, t, threads, st); break;
    case 6: err = launch_c<6>(p, i, o, b, n, s, t, threads, st); break;
    case 7: err = launch_c<7>(p, i, o, b, n, s, t, threads, st); break;
    default: err = launch_c<8>(p, i, o, b, n, s, t, threads, st); break;
  }
  return static_cast<int>(err);
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
