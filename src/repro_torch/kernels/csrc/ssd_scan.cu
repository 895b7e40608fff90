// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/ssd_scan.py:
//   _kernel (wrapper ssd_scan).
// The spec is repro_torch/kernels/ref.py::ssd (the chunked algorithm of
// models/ssm.py::ssd_chunked, all in f32).  Per (batch row b, head h) and
// per chunk c of L steps, with a_cum = cumsum(a) over the chunk:
//   y_c     = ((C B^T) o tril exp(a_cum[i] - a_cum[j])) x    intra-chunk
//           + (C state_c^T) * exp(a_cum)                     carried state
//   local_c = x^T (B * exp(a_cum[L-1] - a_cum))
//   state_{c+1} = state_c * exp(a_cum[L-1]) + local_c
// The kernel agrees with the spec to f32 rounding, not to the bit: sums run
// in another order, products run as 3xTF32 (below), and the log-decay
// prefix is kept in f64.
//
// Bound: operations.  At the serving prefill's shape (S 2048, 64 heads,
// P 64, N 128, L 256) the useful work is ~10.8 GFLOP per call: 4.3 of
// C B^T, whose operands are bf16 there, and 6.5 of products with an f32
// operand, against ~70 MB of x, y, B, C and the states.  Design: Mamba2's
// own split of the chunked algorithm, so that only a short pass is
// sequential.  One call is three launches on the caller's stream:
//   1. chunk_state_kernel, parallel over (P-tile, head, chunk, batch row):
//      the chunk's local state, x^T (B * w) with w = exp(a_cum[L-1] -
//      a_cum), written to a per-chunk state buffer, and the chunk's decay
//      exp(a_cum[L-1]); 8 warps, each a 16 x 64 block of the 64 x 128 state
//      tile;
//   2. state_pass_kernel, parallel over (state element, head, batch row):
//      walks the chunks in order, replacing each chunk's local state by the
//      state that enters it and writing the final state (N*P values a
//      chunk; each step's load is issued before the previous step's
//      store);
//   3. chunk_scan_kernel, parallel over (P-tile, head, chunk, batch row,
//      128-row i-tile): the carried-state term and the intra-chunk term of
//      y together, so that y is written once; 8 warps of 16 rows each.
//      The i-tiles run longest first (the grid's slowest axis, backwards).
//      Against each 64-key j-tile a warp is in one of three cases, alike
//      for all its rows: every key after every row (the warp skips it),
//      every key before every row, or the diagonal.
// Arithmetic, all on the tensor cores:
//   - C B^T with bf16 B and C: mma.sync.m16n8k16, bf16 in, f32 accumulate
//     (the product of two bf16 values is exact in f32: the spec's f32
//     arithmetic summed in another order), fragments by ldmatrix;
//   - every product with an f32 operand (the masked scores times x, the
//     carried-state term, the local state; and C B^T when B and C are f32)
//     as 3xTF32 on mma.sync.m16n8k8: each f32 operand is split into hi
//     (its top 19 bits) and lo = v - hi, and the product taken as hi*hi +
//     hi*lo + lo*hi, which keeps about f32's accuracy (one TF32 product
//     keeps ~3 decimal digits and would miss the 1e-5 bound).  A bf16
//     operand is exact in tf32 and is not split: two products, not three.
//     Each of the three terms runs over all of a row's n-tiles before the
//     next, so consecutive products go to different accumulators;
//   - the f32 scores, held in the accumulator layout of C B^T, are the A
//     fragment of the scores-times-x product as they stand (the k index is
//     permuted alike in A and B; see tensor_core.cuh);
//   - N is padded to 128 and a P-tile to 64 with zeros in shared memory, so
//     that every loop has a compile-time trip count and the unrolled
//     products form one basic block the compiler can schedule.
// The log-decay prefix is taken in f64 (each lane sums a run of steps, one
// warp scan joins the runs), and a_cum[i] - a_cum[j] is taken in f64 before
// its exp: at the model's real decays (|a| up to a few hundred per step in
// the fast heads) a_cum reaches ~1e4, where one f32 ulp (~1e-3) would
// already move exp(a_cum[i] - a_cum[j]) by 1e-3.  Where every key of a
// j-tile lies before every row of the warp, the decay factors through the
// tile's end e into one exp per row and one per key (exp(a_cum[i] -
// a_cum[e]) * exp(a_cum[e] - a_cum[j]), both <= 1 for a decay a <= 0); on
// the diagonal each score takes its own exp, and only where j <= i (0
// elsewhere without evaluating it, as the reference's `where`).
// Loads: the B, C and x sub-tiles and the incoming state are staged with
// 16-byte cp.async (zero-filled past the ragged edges; an unaligned chunk
// of a strided view is read element by element instead), the B/x j-tiles
// double-buffered; x, a, B and C are read in place through their strides,
// so B and C may be a stride-0 view over heads (one B/C group) with no
// expanded copy.  Shared memory of the scan at the prefill shape: 105 KB,
// two blocks of 8 warps a SM; of the chunk states: 71 KB, three blocks.
//
// C interface (bound with ctypes); the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kT = 64;                  // rows of a sub-tile (l, i or j)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 128;              // state_dim
constexpr int kMaxPt = 64;              // P columns per block
constexpr int kLdX = kMaxPt + 4;        // row stride of an x tile (f32)
constexpr int kMaxL = 4096;             // chunk length
constexpr int kPassThreads = 256;

struct Args {
  const float* x;
  const float* a;
  const void* b;
  const void* c;
  const float* s0;
  float* y;
  float* sf;
  float* states;                        // (B, nc, H, P, N) f32
  float* decay;                         // (B, nc, H) f32
  int seq, heads, p, n, len, nc;        // len: chunk length
  // (batch, seq, head) element strides of x, a, b, c, y; s0: (batch, head, p)
  long long xs[3], as[3], bs[3], cs[3], ys[3], ss[3];
};

template <typename TB>
constexpr bool kBf16 = std::is_same<TB, __nv_bfloat16>::value;

__host__ __device__ inline int pad64(int n) { return (n + 63) & ~63; }

// the row stride, in elements, of a B/C sub-tile: kMaxN (N zero-filled up
// to it, so that every loop over N has a compile-time trip count) plus a
// skew that keeps rows 16-byte aligned and sends the fragment loads of
// neighbouring rows to other banks
template <typename TB>
constexpr int kLdB = kMaxN + (kBf16<TB> ? 8 : 4);
constexpr int kLdS = kMaxN + 4;         // row stride of a state tile (f32)

// dst[r * ld + c] = src[r * rs + c] for r < rows_ok, c < cols_ok; zero
// elsewhere in [0, rows) x [0, cols).  cols is a multiple of one 16-byte
// chunk; a chunk that is whole and aligned goes by cp.async, any other is
// read element by element.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src,
                                           long long rs, int rows,
                                           int rows_ok, int cols,
                                           int cols_ok) {
  constexpr int E = 16 / sizeof(T);
  const int nch = cols / E;
  // chunk i = threadIdx.x + kThreads * k is (row r, chunk c), kept by
  // increments rather than a division per chunk
  int r = threadIdx.x / nch, c = threadIdx.x % nch;
  const int dr = kThreads / nch, dc = kThreads % nch;
  for (int i = threadIdx.x; i < rows * nch; i += kThreads) {
    T* d = dst + r * ld + c * E;
    const T* s = src + (long long)r * rs + c * E;
    if (r < rows_ok && (c + 1) * E <= cols_ok &&
        (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      tc::cp_async16(d, s, true);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = (r < rows_ok && c * E + e < cols_ok) ? s[e] : T(0.f);
    }
    r += dr;
    c += dc;
    if (c >= nch) {
      c -= nch;
      ++r;
    }
  }
}

// acum[l] = sum_{m <= l} a[row0 + m] in f64, for l < rows.  Every thread
// loads a part of a into stage (so the strided loads are in flight
// together); then warp 0 sums: each lane a run of consecutive steps, one
// warp scan of the runs' totals, and each lane its run's prefix sums.
// Called by the whole block; ends in a barrier.
__device__ __forceinline__ void scan_decay(double* acum, float* stage,
                                           const float* ag, long long rs,
                                           long long row0, int rows) {
  for (int l = threadIdx.x; l < rows; l += kThreads)
    stage[l] = ag[(row0 + l) * rs];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, run = (rows + 31) / 32;
    const int lo = min(rows, lane * run), hi = min(rows, lo + run);
    double total = 0.0;
    for (int l = lo; l < hi; ++l) total += (double)stage[l];
    double incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    double v = incl - total;           // the sum before this lane's run
    for (int l = lo; l < hi; ++l) {
      v += (double)stage[l];
      acum[l] = v;
    }
  }
  __syncthreads();
}

// the two f32 values at p (8-byte aligned), and a bf16 pair widened
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// d[n] += a b[n] for every n, each operand f32 split into (hi, lo) or,
// where kSplitA / kSplitB is false, exact in tf32 (a bf16 value widened,
// passed as hi with lo unused): hi*hi + hi*lo + lo*hi, two products where
// one side is exact.  Each term runs over all n before the next, so that
// consecutive products go to different accumulators.
template <bool kSplitA, bool kSplitB, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[NT][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float (&b)[NT][2]) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if constexpr (kSplitB) {
        tc::split_tf32(b[n][k], bh[n][k], bl[n][k]);
      } else {
        bh[n][k] = __float_as_uint(b[n][k]);
      }
    }
  }
  if constexpr (kSplitA) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        tc::mma_tf32(d[n], al, bh[n][0], bh[n][1]);
    }
  }
  if constexpr (kSplitB) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        tc::mma_tf32(d[n], ah, bl[n][0], bl[n][1]);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    tc::mma_tf32(d[n], ah, bh[n][0], bh[n][1]);
  }
}

// an A fragment's four values split, or (kSplit false) passed as exact
template <bool kSplit>
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kSplit) {
      tc::split_tf32(v[e], hi[e], lo[e]);
    } else {
      hi[e] = __float_as_uint(v[e]);
      lo[e] = 0u;
    }
  }
}

// ------------------------------------------------ 1. chunk-local states

template <typename TB>
size_t state_smem(int len) {
  return sizeof(double) * pad64(len) + sizeof(float) * pad64(len) +
         2 * (sizeof(TB) * (size_t)kT * kLdB<TB> +
              sizeof(float) * (size_t)kT * kLdX);
}

// block (P-tile x head, chunk, batch row); warp w owns state rows
// p0 + 16 (w % 4) .. + 15 and columns 64 (w / 4) .. + 63
template <typename TB>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int L = a.len, N = a.n;
  constexpr int ld = kLdB<TB>, Pt = kMaxPt, kNW = kMaxN / 2;
  double* acum = reinterpret_cast<double*>(smem4);          // [pad64(L)]
  float* w = reinterpret_cast<float*>(acum + pad64(L));     // [pad64(L)]
  TB* bt = reinterpret_cast<TB*>(w + pad64(L));             // [2][kT][ld]
  float* xt = reinterpret_cast<float*>(bt + 2 * kT * ld);   // [2][kT][kLdX]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pm = 16 * (warp & 3), nb = kNW * (warp >> 2);
  const int n_pt = (a.p + Pt - 1) / Pt;
  const int h = blockIdx.x / n_pt, p0 = (blockIdx.x % n_pt) * Pt;
  const int ch = blockIdx.y, b = blockIdx.z;
  const int live = min(Pt, a.p - p0);
  const long long r0 = (long long)ch * L;
  const float* xg = a.x + b * a.xs[0] + h * a.xs[2] + r0 * a.xs[1] + p0;
  const float* ag = a.a + b * a.as[0] + h * a.as[2];
  const TB* bg = static_cast<const TB*>(a.b) + b * a.bs[0] + h * a.bs[2] +
                 r0 * a.bs[1];
  const int n_lt = (L + kT - 1) / kT;

  stage_tile(bt, ld, bg, a.bs[1], kT, min(kT, L), kMaxN, N);
  stage_tile(xt, kLdX, xg, a.xs[1], kT, min(kT, L), Pt, live);
  tc::cp_async_commit();
  scan_decay(acum, w, ag, a.as[1], r0, L);
  const double last = acum[L - 1];
  for (int l = threadIdx.x; l < pad64(L); l += kThreads)
    w[l] = l < L ? expf((float)(last - acum[l])) : 0.f;
  if (threadIdx.x == 0 && p0 == 0)
    a.decay[((long long)b * a.nc + ch) * a.heads + h] = expf((float)last);

  const bool rows_live = pm < live;
  float acc[kNW / 8][4];
#pragma unroll
  for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int lt = 0; lt < n_lt; ++lt) {
    const int st = lt & 1, l0 = lt * kT;
    if (lt + 1 < n_lt) {
      const int l1 = l0 + kT;
      stage_tile(bt + (st ^ 1) * kT * ld, ld, bg + l1 * a.bs[1], a.bs[1], kT,
                 min(kT, L - l1), kMaxN, N);
      stage_tile(xt + (st ^ 1) * kT * kLdX, kLdX, xg + l1 * a.xs[1],
                 a.xs[1], kT, min(kT, L - l1), Pt, live);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();          // tile lt has landed (and w is written)
    if (rows_live) {
      const TB* bs = bt + st * kT * ld;
      const float* xs = xt + st * kT * kLdX;
#pragma unroll
      for (int ks = 0; ks < kT / 8; ++ks) {
        // A = (x * w)^T: rows p, k = l (t -> l 2t, t + 4 -> l 2t + 1)
        const int la = 8 * ks + 2 * t;
        const float w0 = w[l0 + la], w1 = w[l0 + la + 1];
        const float* x0 = xs + la * kLdX + pm + g;
        const float av[4] = {x0[0] * w0, x0[8] * w0, x0[kLdX] * w1,
                             x0[kLdX + 8] * w1};
        uint32_t ah[4], al[4];
        split4<true>(av, ah, al);
        const TB* b0 = bs + la * ld + nb + g;
        float bv[kNW / 8][2];
#pragma unroll
        for (int j = 0; j < kNW / 8; ++j) {
          bv[j][0] = ld1(b0 + 8 * j);
          bv[j][1] = ld1(b0 + ld + 8 * j);
        }
        mma_3xtf32<true, !kBf16<TB>>(acc, ah, al, bv);
      }
    }
    __syncthreads();          // readers of stage st are done
  }

  if (!rows_live) return;
  float* out = a.states +
               (((long long)b * a.nc + ch) * a.heads + h) * a.p * N;
#pragma unroll
  for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pm + g + 8 * (e >> 1);
      const int n = nb + 8 * j + 2 * t + (e & 1);
      if (p < live && n < N) out[(long long)(p0 + p) * N + n] = acc[j][e];
    }
}

// ------------------------------------------------- 2. passing the state

// thread e of (head, batch row) walks the chunks in order: slot c of the
// state buffer becomes the state entering chunk c
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(const Args a) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long pn = (long long)a.p * a.n;
  if (e >= pn) return;
  const int p = e / a.n, n = e % a.n;
  float run = a.s0 == nullptr
                  ? 0.f
                  : a.s0[b * a.ss[0] + h * a.ss[1] + p * a.ss[2] + n];
  const long long stride = (long long)a.heads * pn;  // one chunk further
  float* slot = a.states + ((long long)b * a.nc * a.heads + h) * pn + e;
  const float* dk = a.decay + (long long)b * a.nc * a.heads + h;
  float local = *slot;
  for (int c = 0; c < a.nc; ++c) {
    // load chunk c + 1's local state before chunk c's slot is written
    const float next = c + 1 < a.nc ? slot[stride] : 0.f;
    *slot = run;
    run = run * dk[(long long)c * a.heads] + local;
    local = next;
    slot += stride;
  }
  a.sf[((long long)b * a.heads + h) * pn + e] = run;
}

// ------------------------------------------------------- 3. chunk scan

constexpr int kTI = 16 * kWarps;        // rows of a scan block's i-tile

// one stage: a B j-tile and an x j-tile, or (stage 1, before the j loop)
// the incoming state
template <typename TB>
constexpr size_t kScanStage =
    sizeof(TB) * kT * kLdB<TB> + sizeof(float) * kT * kLdX >
            sizeof(float) * kMaxPt * kLdS
        ? sizeof(TB) * kT * kLdB<TB> + sizeof(float) * kT * kLdX
        : sizeof(float) * kMaxPt * kLdS;

template <typename TB>
size_t scan_smem(int len) {
  return sizeof(double) * pad64(len) + sizeof(float) * pad64(len) +
         sizeof(TB) * (size_t)kTI * kLdB<TB> + 2 * kScanStage<TB>;
}

// block (P-tile x head, batch row x chunk, i-tile); warp w owns y rows
// i0 + 16w .. + 15 of the chunk and the block's 64 P columns.  Against a
// j-tile of 64 keys each warp is in one of three cases, alike for all its
// rows: every key after every row (skipped), every key before every row
// (the decay factored through the j-tile's end), or the diagonal (one exp
// per visible score).
template <typename TB>
__global__ void __launch_bounds__(kThreads)
chunk_scan_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int L = a.len, N = a.n;
  constexpr int ld = kLdB<TB>, lds = kLdS, Pt = kMaxPt;
  constexpr size_t stage = kScanStage<TB>;
  double* acum = reinterpret_cast<double*>(smem4);          // [pad64(L)]
  float* cf = reinterpret_cast<float*>(acum + pad64(L));    // [pad64(L)]
  TB* ct = reinterpret_cast<TB*>(cf + pad64(L));            // [kTI][ld]
  char* stages = reinterpret_cast<char*>(ct + kTI * ld);    // 2 x stage
  float* sin = reinterpret_cast<float*>(stages + stage);    // [Pt][lds]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int n_pt = (a.p + Pt - 1) / Pt;
  const int h = blockIdx.x / n_pt, p0 = (blockIdx.x % n_pt) * Pt;
  const int b = blockIdx.y / a.nc, ch = blockIdx.y % a.nc;
  const int it = gridDim.z - 1 - blockIdx.z;        // longest first
  const int i0 = it * kTI, ni = min(kTI, L - i0);
  const int live = min(Pt, a.p - p0);
  const long long r0 = (long long)ch * L;
  const float* xg = a.x + b * a.xs[0] + h * a.xs[2] + r0 * a.xs[1] + p0;
  const float* ag = a.a + b * a.as[0] + h * a.as[2];
  const TB* bg = static_cast<const TB*>(a.b) + b * a.bs[0] + h * a.bs[2] +
                 r0 * a.bs[1];
  const TB* cg = static_cast<const TB*>(a.c) + b * a.cs[0] + h * a.cs[2] +
                 (r0 + i0) * a.cs[1];
  const float* sg = a.states +
                    (((long long)b * a.nc + ch) * a.heads + h) * a.p * N +
                    (long long)p0 * N;
  auto bt = [&](int s) {
    return reinterpret_cast<TB*>(stages + s * stage);
  };
  auto xt = [&](int s) {
    return reinterpret_cast<float*>(stages + s * stage + sizeof(TB) * kT * ld);
  };

  // C's i-tile and the incoming state (in stage 1), then j-tile 0
  stage_tile(ct, ld, cg, a.cs[1], kTI, ni, kMaxN, N);
  stage_tile(sin, lds, sg, (long long)N, Pt, live, kMaxN, N);
  tc::cp_async_commit();
  stage_tile(bt(0), ld, bg, a.bs[1], kT, min(kT, L), kMaxN, N);
  stage_tile(xt(0), kLdX, xg, a.xs[1], kT, min(kT, L), Pt, live);
  tc::cp_async_commit();
  const int n_rows = i0 + ni;               // a_cum is needed up to here
  scan_decay(acum, cf, ag, a.as[1], r0, n_rows);
  // key c's factor to the end of its 64-key tile, exp(a_cum[e] - a_cum[c])
  for (int c = threadIdx.x; c < n_rows; c += kThreads) {
    const int e = (c / kT + 1) * kT;
    cf[c] = e < n_rows ? expf((float)(acum[e] - acum[c])) : 0.f;
  }
  tc::cp_async_wait<1>();
  __syncthreads();            // C, the state and the factors are in place

  const int rw = 16 * warp;                 // the warp's first row (tile)
  const int ra = rw + g, rb = ra + 8;       // this thread's rows (tile)
  const bool rows_live = rw < ni;
  float acc[kMaxPt / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxPt / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ---- carried-state term: (C state^T) * exp(a_cum)
  if (rows_live) {
#pragma unroll 4
    for (int ks = 0; ks < kMaxN / 8; ++ks) {
      const TB* c0 = ct + ra * ld + 8 * ks + 2 * t;
      const float2 lo_row = ld2(c0), hi_row = ld2(c0 + 8 * ld);
      const float av[4] = {lo_row.x, hi_row.x, lo_row.y, hi_row.y};
      uint32_t ah[4], al[4];
      split4<!kBf16<TB>>(av, ah, al);     // bf16 C is exact in tf32
      float sv[kMaxPt / 8][2];
#pragma unroll
      for (int n = 0; n < kMaxPt / 8; ++n) {
        const float2 s2 = ld2(sin + (8 * n + g) * lds + 8 * ks + 2 * t);
        sv[n][0] = s2.x;
        sv[n][1] = s2.y;
      }
      mma_3xtf32<!kBf16<TB>, true>(acc, ah, al, sv);
    }
    const float e0 = ra < ni ? expf((float)acum[i0 + ra]) : 0.f;
    const float e1 = rb < ni ? expf((float)acum[i0 + rb]) : 0.f;
#pragma unroll
    for (int n = 0; n < kMaxPt / 8; ++n) {
      acc[n][0] *= e0; acc[n][1] *= e0;
      acc[n][2] *= e1; acc[n][3] *= e1;
    }
  }
  __syncthreads();            // stage 1 (the state) is free

  // ---- intra-chunk term over the j-tiles up to the i-tile's last row
  const int n_jt = (n_rows + kT - 1) / kT;
  for (int jt = 0; jt < n_jt; ++jt) {
    const int st = jt & 1, j0 = jt * kT;
    if (jt + 1 < n_jt) {
      const int j1 = j0 + kT;
      stage_tile(bt(st ^ 1), ld, bg + j1 * a.bs[1], a.bs[1], kT,
                 min(kT, L - j1), kMaxN, N);
      stage_tile(xt(st ^ 1), kLdX, xg + j1 * a.xs[1], a.xs[1], kT,
                 min(kT, L - j1), Pt, live);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();          // j-tile jt has landed
    const int rg = i0 + rw;                 // the warp's first row (chunk)
    if (rows_live && j0 <= rg + 15) {
      const bool below = j0 + kT <= rg;     // every key before every row
      const TB* bs = bt(st);
      const float* xs = xt(st);
      float s[kT / 8][4];
#pragma unroll
      for (int j = 0; j < kT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

      // S = C B^T for the warp's 16 rows and the tile's keys
      if constexpr (kBf16<TB>) {
        const TB* crow = ct + (rw + (lane & 15)) * ld + (lane >> 4) * 8;
#pragma unroll
        for (int kk = 0; kk < kMaxN / 16; ++kk) {
          uint32_t af[4];
          tc::ldmatrix_x4(af, crow + 16 * kk);
#pragma unroll
          for (int jj = 0; jj < kT / 16; ++jj) {
            uint32_t bf[4];
            tc::ldmatrix_x4(bf, bs + (16 * jj + lr + (lm >> 1) * 8) * ld +
                                    16 * kk + (lm & 1) * 8);
            tc::mma_bf16(s[2 * jj], af, bf[0], bf[1]);
            tc::mma_bf16(s[2 * jj + 1], af, bf[2], bf[3]);
          }
        }
      } else {
#pragma unroll 4
        for (int ks = 0; ks < kMaxN / 8; ++ks) {
          const TB* c0 = ct + ra * ld + 8 * ks + 2 * t;
          const float2 lo_row = ld2(c0), hi_row = ld2(c0 + 8 * ld);
          const float av[4] = {lo_row.x, hi_row.x, lo_row.y, hi_row.y};
          uint32_t ah[4], al[4];
          split4<true>(av, ah, al);
          float bv[kT / 8][2];
#pragma unroll
          for (int j = 0; j < kT / 8; ++j) {
            const float2 b2 = ld2(bs + (8 * j + g) * ld + 8 * ks + 2 * t);
            bv[j][0] = b2.x;
            bv[j][1] = b2.y;
          }
          mma_3xtf32<true, true>(s, ah, al, bv);
        }
      }

      // the decay mask
      if (below) {
        // exp(a_cum[r] - a_cum[c]) = exp(a_cum[r] - a_cum[e]) *
        // exp(a_cum[e] - a_cum[c]) through the tile's end e <= r: both <= 1
        const double ae = acum[j0 + kT];
        const float f0 = ra < ni ? expf((float)(acum[i0 + ra] - ae)) : 0.f;
        const float f1 = rb < ni ? expf((float)(acum[i0 + rb] - ae)) : 0.f;
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {
          const float c0 = cf[j0 + 8 * j + 2 * t];
          const float c1 = cf[j0 + 8 * j + 2 * t + 1];
          s[j][0] *= f0 * c0; s[j][1] *= f0 * c1;
          s[j][2] *= f1 * c0; s[j][3] *= f1 * c1;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1 ? rb : ra;
            const int kc = j0 + 8 * j + 2 * t + (e & 1);
            s[j][e] = (kc <= i0 + r && r < ni)
                          ? s[j][e] * expf((float)(acum[i0 + r] - acum[kc]))
                          : 0.f;
          }
      }

      // y += S x: the S tile is the A fragment (k 2t -> t, 2t+1 -> t+4)
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
        const float av[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ah[4], al[4];
        split4<true>(av, ah, al);
        const float* x0 = xs + (8 * j + 2 * t) * kLdX + g;
        float xv[kMaxPt / 8][2];
#pragma unroll
        for (int n = 0; n < kMaxPt / 8; ++n) {
          xv[n][0] = x0[8 * n];
          xv[n][1] = x0[kLdX + 8 * n];
        }
        mma_3xtf32<true, true>(acc, ah, al, xv);
      }
    }
    __syncthreads();          // readers of stage st are done
  }

  if (!rows_live) return;
  float* yg = a.y + b * a.ys[0] + h * a.ys[2] + (r0 + i0) * a.ys[1] + p0;
#pragma unroll
  for (int n = 0; n < kMaxPt / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1 ? rb : ra, col = 8 * n + 2 * t + (e & 1);
      if (r < ni && col < live) yg[r * a.ys[1] + col] = acc[n][e];
    }
}

// raise the kernel's shared-memory ceiling to smem once it is needed
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* configured) {
  if (smem <= *configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = smem;
  return err;
}

template <typename TB>
int launch(Args& a, int batch, cudaStream_t stream) {
  static size_t state_conf = 0, scan_conf = 0;
  // P columns per block: all of P up to 64, in whole 8-column mma tiles
  const int n_pt = (a.p + kMaxPt - 1) / kMaxPt;
  const int n_it = (a.len + kTI - 1) / kTI;
  if ((long long)batch * a.nc > 65535 || a.nc > 65535 ||
      (long long)n_pt * a.heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;

  const size_t s1 = state_smem<TB>(a.len);
  cudaError_t err = allow_smem(chunk_state_kernel<TB>, s1, &state_conf);
  if (err != cudaSuccess) return (int)err;
  chunk_state_kernel<TB><<<dim3((unsigned)(n_pt * a.heads), (unsigned)a.nc,
                                (unsigned)batch),
                           kThreads, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long pn = (long long)a.p * a.n;
  state_pass_kernel<<<dim3((unsigned)((pn + kPassThreads - 1) /
                                      kPassThreads),
                           (unsigned)a.heads, (unsigned)batch),
                      kPassThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t s3 = scan_smem<TB>(a.len);
  err = allow_smem(chunk_scan_kernel<TB>, s3, &scan_conf);
  if (err != cudaSuccess) return (int)err;
  chunk_scan_kernel<TB><<<dim3((unsigned)(n_pt * a.heads),
                               (unsigned)(batch * a.nc), (unsigned)n_it),
                          kThreads, s3, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P) f32, a (B, S, H) f32, b and c (B, S, H, N) f32 or bf16
// (bc_bf16), s0 (B, H, P, N) f32 or null (zeros) -> y (B, S, H, P) f32,
// sf (B, H, P, N) f32
// contiguous; states (B, S / chunk_len, H, P, N) and decay (B, S /
// chunk_len, H) f32 contiguous are the caller's scratch.  strides: 18
// element strides, (batch, seq, head) of x, a, b, c and y, then (batch,
// head, p) of s0; the last dimension of x, b, c, y and s0 is contiguous.
// chunk_len divides seq.
extern "C" int ssd_scan_launch(const float* x, const float* a, const void* b,
                               const void* c, const float* s0, float* y,
                               float* sf, float* states, float* decay,
                               int bc_bf16, int batch, int seq, int heads,
                               int p, int n, int chunk_len,
                               const long long* strides, void* stream) {
  if (batch <= 0 || heads <= 0 || p <= 0 || n <= 0 || n > kMaxN ||
      chunk_len <= 0 || chunk_len > kMaxL || seq % chunk_len != 0 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  Args args;
  args.x = x; args.a = a; args.b = b; args.c = c; args.s0 = s0;
  args.y = y; args.sf = sf; args.states = states; args.decay = decay;
  args.seq = seq; args.heads = heads; args.p = p; args.n = n;
  args.len = chunk_len; args.nc = seq / chunk_len;
  for (int i = 0; i < 3; ++i) {
    args.xs[i] = strides[i];
    args.as[i] = strides[3 + i];
    args.bs[i] = strides[6 + i];
    args.cs[i] = strides[9 + i];
    args.ys[i] = strides[12 + i];
    args.ss[i] = strides[15 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  return bc_bf16 ? launch<__nv_bfloat16>(args, batch, s)
                 : launch<float>(args, batch, s);
}

// the kernel's limits, for the host side's checks: 0 -> largest state_dim,
// 1 -> largest chunk length
extern "C" int ssd_scan_limit(int which) { return which == 0 ? kMaxN : kMaxL; }

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
