// Per-row k smallest on Hopper (sm_90a).
//
// Replaces: act_tpu/ops/topk.py::_ksmallest_kernel (its pallas_call at
// topk.py:84), reached from the group kNN (act_tpu/ops/group.py:_knn_tpu).
//
// Bound: reading the (rows, N) f32 matrix once is the least work, so bytes
// bound it. The rest is selection, latency-bound on one warp a row: emitting
// k winners one round at a time would keep one lane of 32 busy a round, so
// this design finds the k-th key first and every lane works in every pass.
//
// Design: one warp a row, several rows a block. Values become order keys:
// unsigned integers that compare like the floats, with -0 equal to +0 and
// every NaN above +inf, which is where a stable ascending sort puts them.
//  1. Radix select of the k-th smallest key T, 8 bits a pass from the top: a
//     warp-private 256-bin histogram in shared memory (__match_any_sync
//     merges the lanes that share a digit into one atomicAdd), a warp scan
//     over the bins picks the digit and how many keys below it are taken.
//     Once every key left under the prefix is needed, the passes stop early.
//  2. One compaction pass in index order (__ballot_sync + __popc) keeps every
//     key below T and the first of the keys equal to T that are needed.
//  3. The <= k survivors are sorted by (key, index): for k <= 32 one pair a
//     lane and a bitonic network of shuffles; for larger k the same network
//     in the output rows, which serve as scratch.
// A row of at most 64 keys (the DGCNN graph's k=4 over 64 centers) skips the
// radix passes: two keys a lane, sorted, and k rounds of a one-redux warp
// minimum in which the winning lane moves its second key up.
// Values are read back from the input bit for bit (a -0 stays -0). A row whose
// keys fit a block's 227 KB of shared memory beside the warp's scratch
// (N <= 57784) is staged there once and every pass reads it there; a longer
// row is read from device memory (L2) in each pass, so N has no limit.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BINS = 256;
constexpr int HIST_WORDS = BINS + BINS / 32;  // padded: bin b at b + b / 32
// per warp: the histogram and 32 staged survivors (key, index)
constexpr int SCRATCH_WORDS = HIST_WORDS + 2 * 32;  // 328: keeps the row 16-byte aligned
constexpr int SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return 0xfffffffeu;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pair_of(unsigned key, unsigned idx) {
  return ((unsigned long long)key << 32) | idx;
}

// One comparator of the sort: the lower lane keeps the smaller pair.
__device__ __forceinline__ unsigned long long cmpx(unsigned long long v, int lane, int partner) {
  const unsigned long long o = __shfl_sync(FULL, v, partner);
  return (lane < partner) == (o < v) ? o : v;
}

// Bitonic sort of one pair a lane, ascending across the warp, in the form
// whose comparators all put the smaller pair at the lower position: for each
// size, a "flip" comparator (i, i ^ (size - 1)), then half-cleaners at
// strides size/4 .. 1.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    v = cmpx(v, lane, lane ^ (size - 1));
#pragma unroll
    for (int m = size >> 2; m > 0; m >>= 1) v = cmpx(v, lane, lane ^ m);
  }
  return v;
}

// One stage of the same network over k pairs (kk[i], ii[i]) in memory, the
// warp's lanes taking comparators in turn: stride h, lower element i with
// bit h clear, partner i ^ (size - 1) (flip) or i + h.
__device__ __forceinline__ void sort_stage(unsigned* kk, int* ii, int k, int p2, int size,
                                           int h, bool flip, int lane) {
  for (int q = lane; q < p2 / 2; q += 32) {
    const int i = (q / h) * 2 * h + q % h;
    const int partner = flip ? (i ^ (size - 1)) : i + h;
    if (partner < k) {  // a virtual element past k is +inf: nothing moves
      const unsigned long long a = pair_of(kk[i], (unsigned)ii[i]);
      const unsigned long long b = pair_of(kk[partner], (unsigned)ii[partner]);
      if (b < a) {
        kk[i] = (unsigned)(b >> 32);
        ii[i] = (int)(unsigned)b;
        kk[partner] = (unsigned)(a >> 32);
        ii[partner] = (int)(unsigned)a;
      }
    }
  }
  __syncwarp();
}

template <bool STAGED>
__global__ void ksmallest_kernel(const float* __restrict__ d, float* __restrict__ vals,
                                 int* __restrict__ idxs, int rows, int n, int k) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // whole warp leaves; the kernel has no block sync
  const size_t row_words = STAGED ? (n + 3) & ~3 : 0;
  unsigned* hist = smem + (size_t)warp * (SCRATCH_WORDS + row_words);
  unsigned* sk = hist + HIST_WORDS;  // staged survivors, k <= 32
  unsigned* si = sk + 32;
  unsigned* srow = si + 32;
  const float* g = d + (size_t)row * n;
  float* vrow = vals + (size_t)row * k;
  int* irow = idxs + (size_t)row * k;
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one

  auto key_at = [&](int j) -> unsigned { return STAGED ? srow[j] : order_key(g[j]); };

  if (STAGED) {  // the row's keys into shared memory, all loads in flight
    if ((n & 3) == 0 && (reinterpret_cast<size_t>(g) & 15) == 0) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 8
      for (int q = lane; q < n / 4; q += 32) {
        const float4 v = __ldg(g4 + q);
        reinterpret_cast<uint4*>(srow)[q] =
            make_uint4(order_key(v.x), order_key(v.y), order_key(v.z), order_key(v.w));
      }
    } else {
#pragma unroll 8
      for (int j = lane; j < n; j += 32) srow[j] = order_key(__ldg(g + j));
    }
  }

  // -- 1. radix select: prefix/mask of T, krem keys needed at the prefix ----
  unsigned prefix = 0, mask = 0;
  int krem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    __syncwarp();  // every lane has read the last pass's bins and the row
    for (int b = lane; b < HIST_WORDS; b += 32) hist[b] = 0;
    __syncwarp();
#pragma unroll 4
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const unsigned key = j < n ? key_at(j) : 0u;
      const bool in = j < n && (key & mask) == prefix;
      const unsigned digit = (key >> shift) & 0xffu;
      const unsigned peers = __match_any_sync(FULL, in ? digit : 0x100u);
      if (in && (peers & lt) == 0) atomicAdd(&hist[digit + digit / 32], __popc(peers));
    }
    __syncwarp();
    // lane owns bins 8*lane .. 8*lane+7 (conflict-free through the padding)
    unsigned c[8], sum = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int bin = 8 * lane + t;
      c[t] = hist[bin + bin / 32];
      sum += c[t];
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    const unsigned excl = incl - sum;
    const int owner = __ffs(__ballot_sync(FULL, excl < (unsigned)krem && (unsigned)krem <= incl)) - 1;
    unsigned digit = 0, before = excl, cnt = 0;
    bool found = false;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (!found && before + c[t] >= (unsigned)krem) {
        digit = 8 * lane + t;
        cnt = c[t];
        found = true;
      } else if (!found) {
        before += c[t];
      }
    }
    digit = __shfl_sync(FULL, digit, owner);
    before = __shfl_sync(FULL, before, owner);
    cnt = __shfl_sync(FULL, cnt, owner);
    prefix |= digit << shift;
    mask |= 0xffu << shift;
    krem -= (int)before;
    if (cnt == (unsigned)krem) break;  // every key under this prefix is needed
  }

  // -- 2. compaction in index order: keys below the prefix, first krem at it -
  unsigned* ok = k <= 32 ? sk : reinterpret_cast<unsigned*>(vrow);
  unsigned* oi = k <= 32 ? si : reinterpret_cast<unsigned*>(irow);
  int taken = 0, ties = 0;
  for (int j0 = 0; j0 < n && taken < k; j0 += 32) {
    const int j = j0 + lane;
    const unsigned key = j < n ? key_at(j) : 0xffffffffu;
    const unsigned mk = key & mask;
    const bool eq = j < n && mk == prefix;
    const unsigned eqb = __ballot_sync(FULL, eq);
    const bool take = (j < n && mk < prefix) || (eq && ties + __popc(eqb & lt) < krem);
    const unsigned tb = __ballot_sync(FULL, take);
    if (take) {
      const int pos = taken + __popc(tb & lt);
      ok[pos] = key;
      oi[pos] = (unsigned)j;
    }
    taken += __popc(tb);
    ties += __popc(eqb);
  }
  __syncwarp();

  // -- 3. sort the k survivors by (key, index), emit -----------------------
  if (k <= 32) {
    unsigned long long v = lane < k ? pair_of(sk[lane], si[lane]) : ~0ull;
    v = warp_sort(v, lane);
    if (lane < k) {
      const int i = (int)(unsigned)v;
      vrow[lane] = g[i];
      irow[lane] = i;
    }
    return;
  }
  unsigned* kk = reinterpret_cast<unsigned*>(vrow);
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  for (int size = 2; size <= p2; size <<= 1) {
    sort_stage(kk, irow, k, p2, size, size >> 1, true, lane);
    for (int m = size >> 2; m > 0; m >>= 1) sort_stage(kk, irow, k, p2, size, m, false, lane);
  }
  for (int r = lane; r < k; r += 32) vrow[r] = g[irow[r]];
}

// Rows of at most 64: each lane holds the keys at lane and lane + 32, the
// smaller pair first; a round takes the warp's smallest head by one redux
// (a second one only when heads tie on the key), and the lane that held it
// emits it and moves its other key up. Every lane works in every round and
// no lane rescans.
__global__ void ksmallest_small_kernel(const float* __restrict__ d, float* __restrict__ vals,
                                       int* __restrict__ idxs, int rows, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* g = d + (size_t)row * n;
  float* vrow = vals + (size_t)row * k;
  int* irow = idxs + (size_t)row * k;
  unsigned long long a = lane < n ? pair_of(order_key(__ldg(g + lane)), lane) : ~0ull;
  unsigned long long b = lane + 32 < n ? pair_of(order_key(__ldg(g + lane + 32)), lane + 32)
                                       : ~0ull;
  if (b < a) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }
  for (int r = 0; r < k; ++r) {
    const unsigned hk = (unsigned)(a >> 32), hi = (unsigned)a;
    const unsigned m = __reduce_min_sync(FULL, hk);
    unsigned ball = __ballot_sync(FULL, hk == m);
    if (__popc(ball) > 1) {
      const unsigned i = __reduce_min_sync(FULL, hk == m ? hi : 0xffffffffu);
      ball = __ballot_sync(FULL, hk == m && hi == i);
    }
    if (lane == __ffs(ball) - 1) {
      vrow[r] = g[hi];
      irow[r] = (int)hi;
      a = b;
      b = ~0ull;
    }
  }
}

}  // namespace

extern "C" {

// d (rows, N) f32, vals (rows, k) f32, idxs (rows, k) int32; contiguous on
// the device; 1 <= k <= N. Returns the cudaError_t of the launch.
int act_ksmallest(const void* d, void* vals, void* idxs, int rows, int n, int k,
                  void* stream) {
  if (k < 1 || k > n) return (int)cudaErrorInvalidValue;
  if (n <= 64) {  // two keys a lane: k rounds of a warp minimum
    const dim3 grid((rows + 7) / 8), block(256);
    ksmallest_small_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(d), static_cast<float*>(vals), static_cast<int*>(idxs),
        rows, n, k);
    return (int)cudaGetLastError();
  }
  const size_t staged = (size_t)(SCRATCH_WORDS + ((n + 3) & ~3)) * sizeof(unsigned);
  const bool stage = staged <= (size_t)SMEM_LIMIT;
  const size_t per_warp = stage ? staged : SCRATCH_WORDS * sizeof(unsigned);
  int warps = (int)((48 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = (size_t)warps * per_warp;
  const dim3 grid((rows + warps - 1) / warps), block(warps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* D = static_cast<const float*>(d);
  float* V = static_cast<float*>(vals);
  int* I = static_cast<int*>(idxs);
  if (stage) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          ksmallest_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    ksmallest_kernel<true><<<grid, block, smem, st>>>(D, V, I, rows, n, k);
  } else {
    ksmallest_kernel<false><<<grid, block, smem, st>>>(D, V, I, rows, n, k);
  }
  return (int)cudaGetLastError();
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
