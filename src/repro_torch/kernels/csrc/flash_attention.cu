// Blockwise flash attention (forward) for Hopper (sm_90a): causal, sliding
// window, tanh soft-capping and GQA, with an online softmax.
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py:
//   _kernel (wrapper flash_attention).
// The spec is repro_torch/kernels/ref.py::sdpa (the full softmax over masks
// built from positions 0..S-1); this kernel agrees with it to about one
// bf16 ulp (bf16 inputs) or f32 rounding (f32 inputs), not to the bit: the
// online softmax rescales partial sums in another order.
//
// Bound: operations.  At the serving prefill's shape (S 2048, 32 heads,
// Dh 128) the causal products are ~34 GFLOP against ~25 MB of q, k, v and
// o, far above the card's ~295 FLOP/byte balance point.  Design:
//   - one thread block per (q-tile of kBQ rows, head, batch row); a loop
//     inside the block over k-tiles of kBK keys replaces the TPU's
//     sequential last grid axis, and the running max m, denominator l and
//     the (kBQ, Dh) accumulator stay in registers in f32 for the whole loop;
//   - q-tiles are scheduled longest first (causal work grows with the tile
//     index), so the short tiles fill the tail of the grid;
//   - q, k and v are read in place through their strides (any (B, S, H, Dh)
//     view with a unit last stride), GQA reads kv head h / (H / K), and the
//     ragged edge (S not a multiple of the tile) is masked here, so the
//     caller makes no padded copies;
//   - tiles are staged in shared memory as f32 (q and k transposed, so the
//     score product reads 4 q rows and 2 keys per vector load), and each
//     thread owns a 4 x 2 block of scores and a 4 x Dh/16 block of the
//     output: every shared-memory load feeds 4 to 8 FMAs;
//   - k-tiles outside the causal frontier or the window are skipped with the
//     TPU kernel's conditions; a row whose running max is still NEG_INF uses
//     0 as its max, and a row with l == 0 at the end writes zeros.
// The products run as scalar f32 FMAs (explicit fmaf: the build passes
// -fmad=false for the codec's sake); tensor-core tiles (mma/wgmma) and TMA
// are the next step for speed.  Shared memory per block: 4 * (Dh*(kBQ+4) +
// Dh*(kBK+4) + kBK*Dh + kBK*(kBQ+4)) bytes, 78 KB at Dh 128 and 148 KB at
// Dh 256 (above 48 KB through cudaFuncSetAttribute).
//
// C interface (bound with ctypes); the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 32;                 // keys per k-tile
constexpr int kThreads = 256;           // 16 x 16 threads
constexpr int kPadQ = kBQ + 4;          // row stride of the transposed q, p
constexpr int kPadK = kBK + 4;          // row stride of the transposed k
constexpr int kRows = kBQ / 16;         // query rows per thread (4)
constexpr int kCols = kBK / 16;         // score columns per thread (2)
constexpr float kNegInf = -1e30f;

static_assert(kRows == 4 && kCols == 2, "vector loads assume a 4 x 2 block");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, sk, group, window;            // window <= 0: none
  int causal;
  float scale, softcap;                 // softcap <= 0: none
  long long qs[3], ks[3], vs[3], os[3]; // (batch, seq, head) strides
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int kDN = DH / 16;                // output columns per thread
  constexpr int kVec = kDN < 4 ? kDN : 4;     // width of a V vector load
  constexpr int kNV = kDN / kVec;             // V vector loads per key
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [DH][kPadQ] q, transposed
  float* ks = qs + DH * kPadQ;                  // [DH][kPadK] k, transposed
  float* vs = ks + DH * kPadK;                  // [kBK][DH]   v
  float* ps = vs + kBK * DH;                    // [kBK][kPadQ] p, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;    // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] +
                (h / a.group) * a.ks[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] +
                (h / a.group) * a.vs[2];

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, s = q0 + r;
    qs[d * kPadQ + r] = s < a.sq ? to_f32(qg[s * a.qs[1] + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDN];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDN; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (a.sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    // block-level skip, as the TPU kernel: is any (q, k) pair visible?
    if (a.causal && k0 > q0 + kBQ - 1) continue;
    if (a.window > 0 && k0 + kBK - 1 <= q0 - a.window) continue;

    __syncthreads();              // the previous tile's readers are done
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH, s = k0 + r;
      const bool in = s < a.sk;
      ks[d * kPadK + r] = in ? to_f32(kg[s * a.ks[1] + d]) : 0.f;
      vs[r * DH + d] = in ? to_f32(vg[s * a.vs[1] + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[d * kPadQ +
                                                            ty * kRows]);
      const float2 kv = *reinterpret_cast<const float2*>(&ks[d * kPadK +
                                                            tx * kCols]);
      const float qr[kRows] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s[i][0] = fmaf(qr[i], kv.x, s[i][0]);
        s[i][1] = fmaf(qr[i], kv.y, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx * kCols + j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        ok[j] = kp < a.sk && qp < a.sq && (!a.causal || kp <= qp) &&
                (a.window <= 0 || kp > qp - a.window);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        ps[(tx * kCols + j) * kPadQ + ty * kRows + i] = p;
        psum += p;
      }
      const float alpha = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - m_safe);
      l[i] = alpha * l[i] + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDN; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&ps[kk * kPadQ +
                                                            ty * kRows]);
      const float pr[kRows] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jj = 0; jj < kNV; ++jj) {
        const float* vp = &vs[kk * DH + tx * kVec + 16 * kVec * jj];
        float vr[kVec];
        if constexpr (kVec == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vp);
          vr[0] = t.x; vr[1] = t.y; vr[2] = t.z; vr[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vp);
          vr[0] = t.x; vr[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[i][jj * kVec + e] = fmaf(pr[i], vr[e], acc[i][jj * kVec + e]);
      }
    }
  }

  T* og = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= a.sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int jj = 0; jj < kNV; ++jj)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        store(&og[qp * a.os[1] + tx * kVec + 16 * kVec * jj + e],
              acc[i][jj * kVec + e] * inv);
  }
}

constexpr size_t smem_bytes(int dh) {
  return sizeof(float) *
         (size_t)(dh * kPadQ + dh * kPadK + kBK * dh + kBK * kPadQ);
}

template <typename T, int DH>
int launch(const Args& a, int batch, int heads, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(DH);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)((a.sq + kBQ - 1) / kBQ), (unsigned)heads,
                  (unsigned)batch);
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const Args& a, int batch, int heads, int dh,
              cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(a, batch, heads, stream);
    case 64: return launch<T, 64>(a, batch, heads, stream);
    case 128: return launch<T, 128>(a, batch, heads, stream);
    case 256: return launch<T, 256>(a, batch, heads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) of q, k, v, then o; the
// last dimension of each is contiguous.  bf16 != 0: all four are bf16,
// else f32.  window <= 0: no window; softcap <= 0: no soft-capping.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16,
                                      int batch, int sq, int sk, int heads,
                                      int kv_heads, int dh,
                                      const long long* strides, int causal,
                                      int window, float softcap, float scale,
                                      void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.sq = sq; a.sk = sk; a.group = heads / kv_heads;
  a.window = window; a.causal = causal;
  a.scale = scale; a.softcap = softcap;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_dh<__nv_bfloat16>(a, batch, heads, dh, s)
              : launch_dh<float>(a, batch, heads, dh, s);
}

// the tile shape, for the host side's constants: axis 0 -> kBQ, 1 -> kBK
extern "C" int flash_attention_tile(int axis) { return axis == 0 ? kBQ : kBK; }

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
