// Greedy farthest-point sampling on Hopper (sm_90a).
//
// Replaces: act_tpu/ops/fps.py::_fps_kernel_batched (its pallas_call at
// fps.py:186) and, at start index 0, act_tpu/ops/fps.py::_fps_kernel.
//
// Bound: the S-step loop is sequential. Each step needs the whole cloud's
// running minimum before the next center is known, so the time is S times
// the latency of one step: the distance update of a slice of the cloud, a
// cloud-wide (max, first index) reduction and the exchange behind it. Neither
// bytes (the cloud is read once) nor arithmetic (8 flops a point a step)
// bound it at these sizes.
//
// Design: one cloud runs on a thread-block cluster of C blocks, chosen by the
// wrapper (ops/fps.py launch_geometry). Block r of the cluster owns a
// contiguous slice of the cloud. Three bodies keep the slice in three places;
// the wrapper picks one (ops/fps.py fps_body), and act_fps takes the
// registers body up to 16384 points and, above, the streamed body exactly
// when it is given a scratch:
//  - registers (N <= 16384; C = 1, 2, 4 or 8, chosen so that the B*C blocks
//    fit the card's SMs in one wave while each keeps at least 1024 points):
//    coordinates and running minimum in registers, PPT a thread; every block
//    also holds the whole cloud's coordinates in shared memory (12 bytes a
//    point) to look the next center up;
//  - shared (N > 16384, C = 2-16 blocks; a cluster of 16 is non-portable):
//    the block's slice alone, as x, y, z and running minimum in shared
//    memory, 16 bytes a point (about 14000 points a block, 227000 a cloud);
//    a thread walks its points i*threads + tid;
//  - streamed (past that): the same walk, re-reading the slice's
//    coordinates from the points and its running minimum from a (B, N) f32
//    scratch that the wrapper allocates, every step.
// A step:
//  1. each thread updates its points and takes its first maximum (a tree in
//     registers; in order along its walk otherwise);
//  2. each warp reduces a 64-bit key, (float bits of d) << 32 | ~index, with
//     two redux instructions (largest d, then smallest index among them):
//     running distances are >= +0, so unsigned order is value order, and the
//     larger ~index is the smaller index, so the first argmax is the largest
//     key; a padding lane has key 0;
//  3. lane r < C stores the warp's key into block r of the cluster with
//     st.async, which completes its bytes on that block's mbarrier; the
//     shared and streamed bodies send a 20-byte record, the key and the
//     winner's coordinates (16 bytes of key, x, y and 4 of z), as no block
//     holds the whole cloud; the slots and the two mbarriers alternate by
//     step parity;
//  4. every thread waits on its own block's mbarrier for the C*W keys of the
//     step (one block: a plain store and __syncthreads);
//  5. every warp takes the largest key (redux over the lanes, or at one block
//     with at most 8 keys each lane reads them all) and the next center's
//     coordinates: from the whole cloud in shared memory (registers body) or
//     from the winning record.
// One wait a step, no cluster-wide barrier, no warp-0-only stage and no
// device-memory load on the critical path (the streamed body reads its slice
// from the L2 in step 1). The distance is ((dx*dx + dy*dy) + dz*dz) in f32
// with each operation rounded on its own (no FMA contraction), like
// fps.py:128 and the plain version.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;  // no point: the index of a padding lane
constexpr unsigned SLOT_BYTES = 8;     // (d bits) << 32 | ~index
constexpr unsigned REC_BYTES = 20;     // d bits, ~index, x, y (16 bytes) and z (4)
constexpr int REGISTER_POINTS = 16384;  // the registers body's largest cloud

enum Body { REGISTERS = 0, SHARED = 1, STREAMED = 2 };

// Dynamic shared memory of a block: the key slots (2 parities x C*W), the two
// mbarriers and the coordinates of the whole cloud.
__host__ __device__ inline size_t fps_smem_bytes(int cw, int n) {
  return (size_t)2 * cw * SLOT_BYTES + 2 * sizeof(unsigned long long) +
         (size_t)3 * n * sizeof(float);
}

// Of a shared or streamed block: the records (2 parities x C*W), the two
// mbarriers and, in the shared body, the slice's x, y, z and running minimum.
// ops/fps.py big_smem_bytes is the same sum.
__host__ __device__ inline size_t big_smem_bytes(int cw, int slice, bool shared) {
  return (size_t)2 * cw * REC_BYTES + 2 * sizeof(unsigned long long) +
         (shared ? (size_t)4 * slice * sizeof(float) : 0);
}

// Points of a block's slice, ceil(n / c) (n up to 2^31 - 1).
inline int slice_of(int n, int c) { return (int)(((long long)n + c - 1) / c); }

// The body of a launch: registers up to REGISTER_POINTS, else streamed
// exactly when the caller gives it (a scratch, or the query's flag).
inline Body body_of(int n, bool streamed) {
  return n <= REGISTER_POINTS ? REGISTERS : (streamed ? STREAMED : SHARED);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// A store into a block of the cluster that completes its bytes on that
// block's mbarrier.
__device__ __forceinline__ void st_async(unsigned addr, unsigned long long v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               ::"r"(addr), "l"(v), "r"(bar) : "memory");
}

// A record's 16 and 4 bytes, completing on that block's mbarrier.
__device__ __forceinline__ void st_async_v4(unsigned addr, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async_b32(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}" ::"r"(bar), "r"(parity) : "memory");
}

// The warp's lane holding the largest hi and, among those, the smallest j:
// two redux and a ballot.
__device__ __forceinline__ int warp_winner(unsigned hi, unsigned j) {
  const unsigned hmax = __reduce_max_sync(FULL, hi);
  const unsigned jmin = __reduce_min_sync(FULL, hi == hmax ? j : NONE);
  return __ffs(__ballot_sync(FULL, hi == hmax && j == jmin)) - 1;
}

// The largest of the cw keys at k, read by every lane (broadcast loads, four
// running maxima).
__device__ __forceinline__ unsigned long long max_key(const unsigned long long* k, int cw) {
  unsigned long long m0 = 0, m1 = 0, m2 = 0, m3 = 0;
  int q = 0;
  if ((cw & 3) == 0) {  // then k is 16-byte aligned
    for (; q < cw; q += 4) {
      const ulonglong2 a = *reinterpret_cast<const ulonglong2*>(k + q);
      const ulonglong2 b = *reinterpret_cast<const ulonglong2*>(k + q + 2);
      m0 = max(m0, a.x);
      m1 = max(m1, a.y);
      m2 = max(m2, b.x);
      m3 = max(m3, b.y);
    }
  }
  for (; q < cw; ++q) m0 = max(m0, k[q]);
  return max(max(m0, m1), max(m2, m3));
}

// MBAR (a cluster of C > 1 blocks): keys travel by st.async and each block
// waits on its own mbarrier for the C*W keys of the step; else (one block)
// by plain stores and __syncthreads, and at most 8 keys are read by every
// lane itself.
template <int PPT, int MAXT, bool MBAR>
__global__ void __launch_bounds__(MAXT)
fps_kernel(const float* __restrict__ pts, const int* __restrict__ start,
           int* __restrict__ out, int n, int s_total, int slice) {
  extern __shared__ unsigned long long smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int cw = csize * nw;
  unsigned long long* s_key = smem;                // [2][cw]
  unsigned long long* s_bar = s_key + 2 * cw;      // [2]
  float* s_xyz = reinterpret_cast<float*>(s_bar + 2);  // [n][3], the whole cloud
  const float* p = pts + (size_t)b * n * 3;
  int* o = out + (size_t)b * s_total;
  const int base = rank * slice;
  const int lim = min(n - base, slice);  // points of this block's slice

  for (int q = tid; q < 3 * n; q += nt) s_xyz[q] = p[q];
  float x[PPT], y[PPT], z[PPT], d[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int l = i * nt + tid;
    if (l < lim) {
      x[i] = p[3 * (base + l)];
      y[i] = p[3 * (base + l) + 1];
      z[i] = p[3 * (base + l) + 2];
      d[i] = INFINITY;
    } else {  // padding: -1 never beats a real distance (>= 0)
      x[i] = y[i] = z[i] = 0.f;
      d[i] = -1.f;
    }
  }

  int cur = start[b];
  cur = cur < 0 ? 0 : (cur >= n ? n - 1 : cur);
  if (rank == 0 && tid == 0) o[0] = cur;
  float cx = __ldg(p + 3 * cur);
  float cy = __ldg(p + 3 * cur + 1);
  float cz = __ldg(p + 3 * cur + 2);
  if (MBAR && tid == 0) {
    mbar_init(smem_addr(s_bar));
    mbar_init(smem_addr(s_bar + 1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // barriers set, the cloud staged, every block's shared memory live
  if (MBAR) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  // lane r < C sends the warp's key to block r
  const unsigned key_base = cluster_addr(smem_addr(s_key), lane < (int)csize ? lane : 0);
  const unsigned bar_base = cluster_addr(smem_addr(s_bar), lane < (int)csize ? lane : 0);

  for (int s = 1; s < s_total; ++s) {
    const int par = s & 1;
    if (MBAR && tid == 0) mbar_expect(smem_addr(s_bar + par), cw * SLOT_BYTES);
    float td[PPT];
    int ti[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float dx = __fsub_rn(x[i], cx);
      const float dy = __fsub_rn(y[i], cy);
      const float dz = __fsub_rn(z[i], cz);
      const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      d[i] = fminf(d[i], dd);
      td[i] = d[i];
      ti[i] = i;
    }
    // the thread's first maximum by a tree: the right (later) candidate wins
    // only when strictly larger
#pragma unroll
    for (int w = 1; w < PPT; w <<= 1) {
#pragma unroll
      for (int i = 0; i + w < PPT; i += 2 * w) {
        if (td[i + w] > td[i]) {
          td[i] = td[i + w];
          ti[i] = ti[i + w];
        }
      }
    }
    const float best = td[0];
    const bool real = best >= 0.f;  // else this thread holds padding only
    const unsigned hi = real ? __float_as_uint(best) : 0u;
    const unsigned j = real ? (unsigned)(base + ti[0] * nt + tid) : NONE;
    const int wl = warp_winner(hi, j);
    // an all-padding warp sends key 0, which every real point (~j >= 1) beats
    const unsigned long long key =
        __shfl_sync(FULL, ((unsigned long long)hi << 32) | (unsigned)~j, wl);
    const int slot = par * cw + rank * nw + warp;
    if (MBAR) {
      if (lane < (int)csize) {
        st_async(key_base + slot * SLOT_BYTES, key, bar_base + par * sizeof(unsigned long long));
      }
      mbar_wait(smem_addr(s_bar + par), ((s - 1) >> 1) & 1);
    } else {
      if (lane == 0) s_key[slot] = key;
      __syncthreads();
    }
    // every warp reduces the cw keys: (d bits, then ~index) largest wins
    unsigned win;
    if (!MBAR && cw <= 8) {
      win = ~(unsigned)max_key(s_key + par * cw, cw);
    } else {
      unsigned long long bk = 0;
      for (int q = lane; q < cw; q += 32) bk = max(bk, s_key[par * cw + q]);
      const unsigned bj = ~(unsigned)bk;  // the winner's index, or NONE (no key)
      win = __shfl_sync(FULL, bj, warp_winner((unsigned)(bk >> 32), bj));
    }
    cx = s_xyz[3 * win];
    cy = s_xyz[3 * win + 1];
    cz = s_xyz[3 * win + 2];
    if (rank == 0 && tid == 0) o[s] = (int)win;
  }
}

// The shared (STREAM false) and streamed (STREAM true) bodies: a cluster of
// 2-16 blocks, the slice's points walked i*threads + tid in shared memory or
// from the points and the scratch, 20-byte records of key and coordinates.
template <bool STREAM>
__global__ void __launch_bounds__(1024)
fps_big_kernel(const float* __restrict__ pts, const int* __restrict__ start,
               int* __restrict__ out, float* __restrict__ scratch, int n, int s_total,
               int slice) {
  extern __shared__ __align__(16) unsigned char big_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int cw = csize * nw;
  uint4* s_rec = reinterpret_cast<uint4*>(big_smem);         // [2][cw]: d, ~index, x, y
  float* s_recz = reinterpret_cast<float*>(s_rec + 2 * cw);  // [2][cw]: z
  unsigned long long* s_bar = reinterpret_cast<unsigned long long*>(s_recz + 2 * cw);  // [2]
  float* sx = reinterpret_cast<float*>(s_bar + 2);  // shared body: [slice] each
  float* sy = sx + slice;
  float* sz = sy + slice;
  float* sd = sz + slice;
  const float* p = pts + (size_t)b * n * 3;
  int* o = out + (size_t)b * s_total;
  const int base = rank * slice;
  const int lim = max(0, min(n - base, slice));  // points of this block's slice
  const float* q = p + (size_t)3 * base;          // the slice's coordinates
  float* gd = STREAM ? scratch + (size_t)b * n + base : nullptr;  // its running minima

  // a thread reads and writes only its own points, in every step
  for (int l = tid; l < lim; l += nt) {
    if (STREAM) {
      gd[l] = INFINITY;
    } else {
      sx[l] = q[(size_t)3 * l];
      sy[l] = q[(size_t)3 * l + 1];
      sz[l] = q[(size_t)3 * l + 2];
      sd[l] = INFINITY;
    }
  }

  int cur = start[b];
  cur = cur < 0 ? 0 : (cur >= n ? n - 1 : cur);
  if (rank == 0 && tid == 0) o[0] = cur;
  float cx = __ldg(p + (size_t)3 * cur);
  float cy = __ldg(p + (size_t)3 * cur + 1);
  float cz = __ldg(p + (size_t)3 * cur + 2);
  if (tid == 0) {
    mbar_init(smem_addr(s_bar));
    mbar_init(smem_addr(s_bar + 1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // barriers set, every block's shared memory live
  const unsigned peer = lane < (int)csize ? lane : 0;  // lane r < C sends to block r
  const unsigned rec_base = cluster_addr(smem_addr(s_rec), peer);
  const unsigned z_base = cluster_addr(smem_addr(s_recz), peer);
  const unsigned bar_base = cluster_addr(smem_addr(s_bar), peer);

  for (int s = 1; s < s_total; ++s) {
    const int par = s & 1;
    if (tid == 0) mbar_expect(smem_addr(s_bar + par), cw * REC_BYTES);
    // the thread's first maximum along its walk: a later point wins only when
    // strictly larger; -1 (no point) never beats a real distance (>= 0)
    float best = -1.f, bx = 0.f, by = 0.f, bz = 0.f;
    int bl = 0;
#pragma unroll 4
    for (int l = tid; l < lim; l += nt) {
      float x, y, z, d;
      if (STREAM) {
        x = __ldg(q + (size_t)3 * l);
        y = __ldg(q + (size_t)3 * l + 1);
        z = __ldg(q + (size_t)3 * l + 2);
        d = gd[l];
      } else {
        x = sx[l];
        y = sy[l];
        z = sz[l];
        d = sd[l];
      }
      const float dx = __fsub_rn(x, cx);
      const float dy = __fsub_rn(y, cy);
      const float dz = __fsub_rn(z, cz);
      const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      d = fminf(d, dd);
      if (STREAM) {
        gd[l] = d;
      } else {
        sd[l] = d;
      }
      if (d > best) {
        best = d;
        bl = l;
        bx = x;
        by = y;
        bz = z;
      }
    }
    const bool real = best >= 0.f;
    const unsigned hi = real ? __float_as_uint(best) : 0u;
    const unsigned j = real ? (unsigned)(base + bl) : NONE;
    const int wl = warp_winner(hi, j);
    // an all-padding warp sends key 0, which every real point (~j >= 1) beats
    const uint4 rec = make_uint4(__shfl_sync(FULL, hi, wl), ~__shfl_sync(FULL, j, wl),
                                 __shfl_sync(FULL, __float_as_uint(bx), wl),
                                 __shfl_sync(FULL, __float_as_uint(by), wl));
    const unsigned rz = __shfl_sync(FULL, __float_as_uint(bz), wl);
    const int slot = par * cw + rank * nw + warp;
    if (lane < (int)csize) {
      const unsigned bar = bar_base + par * sizeof(unsigned long long);
      st_async_v4(rec_base + slot * 16, rec, bar);
      st_async_b32(z_base + slot * 4, rz, bar);
    }
    mbar_wait(smem_addr(s_bar + par), ((s - 1) >> 1) & 1);
    // every warp reduces the cw keys and reads the winner's record
    unsigned long long bk = 0;
    int bq = 0;
    for (int k = lane; k < cw; k += 32) {
      const uint2 kk = *reinterpret_cast<const uint2*>(s_rec + par * cw + k);
      const unsigned long long key = ((unsigned long long)kk.x << 32) | kk.y;
      if (key > bk) {
        bk = key;
        bq = k;
      }
    }
    const unsigned bj = ~(unsigned)bk;
    const int wk = warp_winner((unsigned)(bk >> 32), bj);
    const unsigned win = __shfl_sync(FULL, bj, wk);
    const int wq = par * cw + __shfl_sync(FULL, bq, wk);
    const uint4 r = s_rec[wq];
    cx = __uint_as_float(r.z);
    cy = __uint_as_float(r.w);
    cz = s_recz[wq];
    if (rank == 0 && tid == 0) o[s] = (int)win;
  }
}

using Kernel = void (*)(const float*, const int*, int*, int, int, int);
using BigKernel = void (*)(const float*, const int*, int*, float*, int, int, int);

// The instantiation for ppt points a thread and C blocks a cloud; at 16
// points a thread a block of at most 512 threads may use 128 registers a
// thread and keeps its points out of local memory.
template <bool MBAR>
Kernel pick_ppt(int ppt, int threads) {
  switch (ppt) {
    case 1: return fps_kernel<1, 1024, MBAR>;
    case 2: return fps_kernel<2, 1024, MBAR>;
    case 4: return fps_kernel<4, 1024, MBAR>;
    case 8: return fps_kernel<8, 1024, MBAR>;
    case 16: return threads <= 512 ? fps_kernel<16, 512, MBAR> : fps_kernel<16, 1024, MBAR>;
    default: return nullptr;
  }
}

Kernel pick(int c, int ppt, int threads) {
  return c > 1 ? pick_ppt<true>(ppt, threads) : pick_ppt<false>(ppt, threads);
}

BigKernel pick_big(Body body) {
  return body == STREAMED ? fps_big_kernel<true> : fps_big_kernel<false>;
}

// The launch's dynamic shared memory and cluster; a cluster of 16 blocks is
// non-portable and must be allowed first.
template <typename K>
cudaError_t prepare(K kernel, int c, int threads, size_t smem, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (c > 8) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The block's shared memory is checked by the runtime: cudaFuncSetAttribute
// (prepare) refuses more than the card's opt-in limit.
bool geometry_ok(int n, int c, int threads, int ppt, Body body) {
  if (n < 1 || c < 1 || c > 16) return false;
  if (threads < 32 || threads > 1024 || threads % 32 != 0 ||
      (long long)threads * ppt < slice_of(n, c)) {
    return false;
  }
  return body == REGISTERS ? (c == 1 || c == 2 || c == 4 || c == 8)
                           : (c == 2 || c == 4 || c == 8 || c == 16);
}

// The launch, or with `count` the card's cudaOccupancyMaxActiveClusters of it.
cudaError_t run(const void* pts, const void* start, void* out, void* scratch, int b, int n,
                int s, int c, int threads, int ppt, Body body, cudaStream_t stream,
                int* count) {
  if (!geometry_ok(n, c, threads, ppt, body)) return cudaErrorInvalidValue;
  const int slice = slice_of(n, c);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(count ? c : b * c);
  cfg.stream = stream;
  cudaError_t e;
  if (body == REGISTERS) {
    const Kernel kernel = pick(c, ppt, threads);
    if (!kernel) return cudaErrorInvalidValue;
    e = prepare(kernel, c, threads, fps_smem_bytes(c * (threads / 32), n), &cfg, &attr);
    if (e != cudaSuccess) return e;
    if (count) return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(pts),
                           static_cast<const int*>(start), static_cast<int*>(out), n, s, slice);
  } else {
    const BigKernel kernel = pick_big(body);
    e = prepare(kernel, c, threads, big_smem_bytes(c * (threads / 32), slice, body == SHARED),
                &cfg, &attr);
    if (e != cudaSuccess) return e;
    if (count) return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(pts),
                           static_cast<const int*>(start), static_cast<int*>(out),
                           static_cast<float*>(scratch), n, s, slice);
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pts (B, N, 3) f32, start (B,) int32, out (B, S) int32; all contiguous on
// the device; 1 <= N < 2^31. One cloud runs on a cluster of c blocks of
// `threads` threads; c * threads * ppt >= N. The registers body (N <= 16384)
// takes c = 1, 2, 4 or 8 and ppt = 1, 2, 4, 8 or 16 points a thread; the
// shared and streamed bodies c = 2, 4, 8 or 16. Above 16384 points a
// non-null scratch, a (B, N) f32 buffer, selects the streamed body; null the
// shared one. Returns the cudaError_t of the launch.
int act_fps(const void* pts, const void* start, void* out, void* scratch, int b, int n, int s,
            int c, int threads, int ppt, void* stream) {
  return (int)run(pts, start, out, scratch, b, n, s, c, threads, ppt,
                  body_of(n, scratch != nullptr), static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of this geometry and body (streamed nonzero: the
// streamed body above 16384 points) the card runs at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
int act_fps_max_clusters(int n, int c, int threads, int ppt, int streamed) {
  int count = 0;
  const cudaError_t e = run(nullptr, nullptr, nullptr, nullptr, 1, n, 1, c, threads, ppt,
                            body_of(n, streamed != 0), nullptr, &count);
  return e == cudaSuccess ? count : -(int)e;
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
