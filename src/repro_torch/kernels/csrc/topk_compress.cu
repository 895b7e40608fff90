// Block-balanced top-k selection for Hopper (sm_90a): the legacy sparse
// fp32 shipping of the inter-pod ring.
//
// Replaces the Pallas TPU kernel of repro/kernels/topk_compress.py:
//   _kernel (wrapper topk_compress_pallas), an iterative argmax per block.
// The spec is repro_torch/kernels/ref.py topk_block: per block of `block`
// values, the k_block largest |x|, ties to the lowest index, written in
// descending order (selection order, not index order); values in x's dtype
// and bits, indices block base + j.  The kernel reproduces it bit for bit.
//
// Input: rows of a (pods, numel) tensor, each cut into chunks of `chunk`
// values (the last chunk zero-padded), each chunk into blocks of `block`
// values (the last block zero-padded).  Both pads are never materialized:
// a position past the data reads as +0.0 and takes part in the selection,
// as the reference's jnp.pad zeros do.  Output: per (pod, chunk) row,
// nb * k_block values and int32 indices within the chunk; the wrapper
// clamps pad winners to chunk - 1 and cuts the row to k.
//
// Bound: memory.  Every input value is read once (4 bytes f32, 2 bytes
// bf16); the output is ~1% of that at top-k 0.01.  The work per value has
// to stay a few instructions, or issue bounds the kernel instead.  Design:
//   - one warp per (row, block) tile of up to 1024 values, eight tiles per
//     thread block, tiles on gridDim.x (1.64M tiles per round on the main
//     path).  The warp copies its tile into shared memory, with all of a
//     lane's loads in flight at once (16-byte loads when every tile starts
//     16-byte aligned and is whole), and keeps each lane's largest key;
//     the passes then take positions l, l + 32, ... in lane l.  Keeping
//     the tile in shared memory instead of 32 registers a lane keeps the
//     loops rolled, the code small and ~48 registers a thread: five
//     blocks (40 warps) an SM;
//   - the key is |x| bits + 1 (0 marks a slot past the block), so -0.0
//     ties with +0.0 by index and bf16 widens to f32 exactly;
//   - threshold, then one compaction (k_block <= 32; the main path's is
//     10): a bitonic sort of the 32 lane maxima gives L, their k_block-th
//     largest, a lower bound on the tile's k_block-th key (the k_block
//     largest lane maxima are distinct values of the tile).  One pass
//     ballots the keys above L and appends them, in index order, to a
//     32-entry list in shared memory, as one word each that orders as the
//     selection does (key, then the lower index; the sign in bit 0).  If
//     at most 32 keys are above L, one per lane is bitonic-sorted (16
//     lanes when at most 16); the first k_block of them, then the first
//     keys equal to L in index order (a second pass, only when fewer than
//     k_block keys are above L), are the winners, and one coalesced store
//     per warp writes them from the words (no second read of x);
//   - the general branch, the same kernel's second path per tile: k_block
//     rounds of a lane-local max (strict >, so the lowest position of a
//     tie stays) and a 5-step butterfly over (key, -index).  It takes
//     k_block > 32 (the reference's tests use 512) and tiles with more
//     than 32 keys above L: a few lanes holding many of the largest
//     values, as inputs whose large values repeat at a stride of 32 or 16
//     positions do.
// -DKERNEL_SPLIT=1 (loads only) and 2 (no output writes) build the time
// split of tools/kernel_ab.py --split; the default 0 is the kernel.
//
// C interface (bound with ctypes); the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef KERNEL_SPLIT
#define KERNEL_SPLIT 0
#endif

namespace {

constexpr int kWarps = 8;            // tiles per thread block
constexpr int kMaxBlock = 1024;      // 32 values per lane
constexpr int kFastK = 32;           // largest k_block of the fast path
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;

__device__ __forceinline__ uint32_t raw_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t raw_bits(uint16_t v) { return v; }

// |x| as f32 bits: bf16 (in the low 16 bits) widens exactly
template <typename T>
__device__ __forceinline__ uint32_t mag_bits(uint32_t raw) {
  return (sizeof(T) == 2 ? raw << 16 : raw) & 0x7fffffffu;
}

template <typename T>
__device__ __forceinline__ T from_raw(uint32_t r);
template <>
__device__ __forceinline__ float from_raw<float>(uint32_t r) {
  return __uint_as_float(r);
}
template <>
__device__ __forceinline__ uint16_t from_raw<uint16_t>(uint32_t r) {
  return (uint16_t)r;
}

// the value whose key is `key` (>= 1) and whose sign bit is `sign`
template <typename T>
__device__ __forceinline__ T from_key(uint32_t key, uint32_t sign);
template <>
__device__ __forceinline__ float from_key<float>(uint32_t key,
                                                 uint32_t sign) {
  return __uint_as_float(sign << 31 | (key - 1));
}
template <>
__device__ __forceinline__ uint16_t from_key<uint16_t>(uint32_t key,
                                                       uint32_t sign) {
  return (uint16_t)(sign << 15 | (key - 1) >> 16);
}

// a candidate as one word that orders as the selection does: the key,
// then the lower position first; the sign rides in bit 0
__device__ __forceinline__ u64 pack(uint32_t key, int j,
                                         uint32_t sign) {
  return (u64)key << 32 | (uint32_t)(kMaxBlock - 1 - j) << 1 | sign;
}

// the lane's value after a descending bitonic sort of lanes 0 .. N - 1
// (N = 16: lanes 16 .. 31 sort among themselves)
template <int N = 32, typename V>
__device__ __forceinline__ V warp_sort_desc(V v, int lane) {
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const V o = __shfl_xor_sync(kFull, v, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_max ? max(v, o) : min(v, o);
    }
  }
  return v;
}

// 5 blocks an SM: at most 51 registers a thread and no spills (at 6 the
// compiler spills, and on an H100 a round of the main path took longer)
template <typename T, int VPL, bool VEC>
__global__ void __launch_bounds__(kWarps * 32, 5)
topk_kernel(const T* __restrict__ x, long long row_stride, long long numel,
            long long n_chunks, long long chunk, long long nb, int block,
            int k_block, long long n_tiles, T* __restrict__ vals,
            int32_t* __restrict__ idx) {
  // per warp: the tile's values (bits) in position order, 0 past the
  // data; the packed keys above L ([0]) and equal to L ([1]), the first
  // 32 of each in index order
  __shared__ __align__(16) T tile_raw[kWarps][32 * VPL];
  __shared__ u64 list[kWarps][2][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = (long long)blockIdx.x * kWarps + warp;
  if (tile >= n_tiles) return;                 // the whole warp leaves
  const long long row = tile / nb;             // (pod, chunk)
  const long long b = tile - row * nb;
  const long long pod = row / n_chunks;
  const long long lo = (row - pod * n_chunks) * chunk;
  const T* src = x + pod * row_stride + lo;
  const long long valid = min(chunk, numel - lo);   // the rest reads 0
  const long long base = b * block;
  const T* tsrc = src + base;
  const int n_in = (int)max(0LL, min(valid - base, (long long)block));

  // load the tile into shared memory; each lane's maximum key over the
  // positions it loaded (a key is |x| bits + 1, 0 for no position)
  T* raw = tile_raw[warp];
  uint32_t lane_max = 0;
  auto take_max = [&](uint32_t w) {            // one 32-bit word's values
    if (sizeof(T) == 2) {
      lane_max = max(lane_max, mag_bits<T>(w & 0xffffu) + 1);
      lane_max = max(lane_max, mag_bits<T>(w >> 16) + 1);
    } else {
      lane_max = max(lane_max, mag_bits<T>(w) + 1);
    }
  };
  bool loaded = false;
  if constexpr (VEC) {
    if (n_in == 32 * VPL) {                    // a whole tile of data
      loaded = true;
      // all loads first, so that they are in flight together
      constexpr int E = 16 / sizeof(T);        // values per load
      static_assert(VPL % E == 0, "a lane loads whole 16 bytes");
      uint4 u[VPL / E];
#pragma unroll
      for (int c = 0; c < VPL / E; ++c)
        u[c] = *reinterpret_cast<const uint4*>(tsrc + 32 * E * c + E * lane);
#pragma unroll
      for (int c = 0; c < VPL / E; ++c) {
        *reinterpret_cast<uint4*>(raw + 32 * E * c + E * lane) = u[c];
        take_max(u[c].x);
        take_max(u[c].y);
        take_max(u[c].z);
        take_max(u[c].w);
      }
    }
  }
  if (!loaded) {
    uint32_t r[VPL];
#pragma unroll
    for (int t = 0; t < VPL; ++t)
      r[t] = 32 * t + lane < n_in ? raw_bits(tsrc[32 * t + lane]) : 0u;
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
      raw[32 * t + lane] = from_raw<T>(r[t]);
      if (32 * t + lane < block)
        lane_max = max(lane_max, mag_bits<T>(r[t]) + 1);
    }
  }
  __syncwarp();
  // the passes: lane l takes positions l + 32 t; key and sign of slot t
  const int in_block = block - lane;
  auto bits_at = [&](int t) -> uint32_t {
    return raw_bits(raw[32 * t + lane]);
  };
  auto key_of = [&](int t, uint32_t r) -> uint32_t {
    return 32 * t < in_block ? mag_bits<T>(r) + 1 : 0u;
  };
  auto sign_of = [](uint32_t r) -> uint32_t {
    return r >> (8 * sizeof(T) - 1);
  };

  T* vout = vals + tile * k_block;
  int32_t* iout = idx + tile * k_block;
  uint32_t chk = 0;
  if (KERNEL_SPLIT == 1) {
    if (lane_max == kFull) iout[0] = 1;
    return;
  }

  if (k_block <= kFastK) {
    const uint32_t L =
        __shfl_sync(kFull, warp_sort_desc(lane_max, lane), k_block - 1);
    u64* gt_list = list[warp][0];
    u64* eq_list = list[warp][1];
    const unsigned below = (1u << lane) - 1u;
    int n_gt = 0;
#pragma unroll 4
    for (int t = 0; t < VPL; ++t) {
      const uint32_t rb = bits_at(t), k = key_of(t, rb);
      const unsigned gt = __ballot_sync(kFull, k > L);
      if (gt) {
        const int r = n_gt + __popc(gt & below);
        if (k > L && r < 32)
          gt_list[r] = pack(k, 32 * t + lane, sign_of(rb));
        n_gt += __popc(gt);
      }
    }
    if (n_gt <= 32) {
      // the first keys equal to L, in index order, after those above it
      for (int t = 0, n_eq = 0; t < VPL && n_eq < k_block - n_gt; ++t) {
        const uint32_t rb = bits_at(t), k = key_of(t, rb);
        const unsigned eq = __ballot_sync(kFull, k == L);
        const int r = n_eq + __popc(eq & below);
        if (k == L && r < 32)
          eq_list[r] = pack(k, 32 * t + lane, sign_of(rb));
        n_eq += __popc(eq);
      }
      __syncwarp();
      // one key above L per lane (the rest 0, last), sorted: lane r then
      // holds the r-th winner; after them come the keys equal to L
      u64 w = lane < n_gt ? gt_list[lane] : (u64)0;
      w = n_gt <= 16 ? warp_sort_desc<16>(w, lane) : warp_sort_desc(w, lane);
      if (lane >= n_gt && lane < k_block) w = eq_list[lane - n_gt];
      const uint32_t wk = (uint32_t)(w >> 32), wlo = (uint32_t)w;
      const int j = kMaxBlock - 1 - (int)(wlo >> 1);
      if (KERNEL_SPLIT == 2) {
        chk = __reduce_add_sync(kFull, wk + j);
        if (chk == kFull) iout[0] = 1;
        return;
      }
      if (lane < k_block) {
        vout[lane] = from_key<T>(wk, wlo & 1u);
        iout[lane] = (int32_t)(base + j);
      }
      return;
    }
  }

  // general branch: k_block rounds of a warp argmax over (key, -index)
  uint32_t live = 0;
  for (int t = 0; t < VPL; ++t)
    if (32 * t < in_block) live |= 1u << t;
  for (int r = 0; r < k_block; ++r) {
    uint32_t bm = 0;
    int bj = 0;                                // lane-local best
    for (int t = 0; t < VPL; ++t) {
      const uint32_t m = live >> t & 1u ? mag_bits<T>(bits_at(t)) + 1 : 0u;
      if (m > bm) {
        bm = m;
        bj = lane + 32 * t;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const uint32_t om = __shfl_xor_sync(kFull, bm, o);
      const int oj = __shfl_xor_sync(kFull, bj, o);
      if (om > bm || (om == bm && oj < bj)) {
        bm = om;
        bj = oj;
      }
    }
    if ((bj & 31) == lane) {
      live &= ~(1u << (bj >> 5));
      if (KERNEL_SPLIT == 2) {
        chk += bm + bj;
      } else {
        vout[r] = raw[bj];
        iout[r] = (int32_t)(base + bj);
      }
    }
  }
  if (KERNEL_SPLIT == 2 && chk == kFull) iout[0] = 1;
}

template <typename T, int VPL, bool VEC>
int launch(const T* x, long long row_stride, int rows, long long numel,
           long long n_chunks, long long chunk, int block, int k_block,
           T* vals, int32_t* idx, cudaStream_t s) {
  const long long nb = (chunk + block - 1) / block;
  const long long n_tiles = (long long)rows * n_chunks * nb;
  const long long grid = (n_tiles + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  topk_kernel<T, VPL, VEC><<<(unsigned)grid, kWarps * 32, 0, s>>>(
      x, row_stride, numel, n_chunks, chunk, nb, block, k_block, n_tiles,
      vals, idx);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, long long row_stride, int rows, long long numel,
             long long n_chunks, long long chunk, int block, int k_block,
             T* vals, int32_t* idx, cudaStream_t s) {
  const int vpl = (block + 31) / 32;
  // 16-byte loads: every tile starts 16-byte aligned
  constexpr int E = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   row_stride % E == 0 && chunk % E == 0 && block % E == 0;
#define TOPK_CASE(V)                                                       \
  if (vpl <= V) {                                                          \
    if (V % E == 0 && vec)                                                 \
      return launch<T, V, (V % E == 0)>(x, row_stride, rows, numel,        \
                                         n_chunks, chunk, block, k_block,  \
                                         vals, idx, s);                    \
    return launch<T, V, false>(x, row_stride, rows, numel, n_chunks,       \
                               chunk, block, k_block, vals, idx, s);       \
  }
  TOPK_CASE(1)
  TOPK_CASE(2)
  TOPK_CASE(4)
  TOPK_CASE(8)
  TOPK_CASE(16)
  TOPK_CASE(32)
#undef TOPK_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: rows of `numel` values (f32, or bf16 when bf16 != 0) `row_stride`
// elements apart; each row cut into n_chunks chunks of `chunk` values and
// each chunk into blocks of `block` (<= 1024) values.  vals (same dtype)
// and idx (int32): (rows * n_chunks, ceil(chunk / block) * k_block).
extern "C" int topk_compress_launch(const void* x, int bf16,
                                    long long row_stride, int rows,
                                    long long numel, long long n_chunks,
                                    long long chunk, int block, int k_block,
                                    void* vals, int32_t* idx, void* stream) {
  if (block < 1 || block > kMaxBlock || k_block < 1 || k_block > block)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch<uint16_t>((const uint16_t*)x, row_stride, rows, numel,
                              n_chunks, chunk, block, k_block,
                              (uint16_t*)vals, idx, s);
  return dispatch<float>((const float*)x, row_stride, rows, numel, n_chunks,
                         chunk, block, k_block, (float*)vals, idx, s);
}

extern "C" int topk_compress_max_block() { return kMaxBlock; }

extern "C" const char* topk_compress_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
