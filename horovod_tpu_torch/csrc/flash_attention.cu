// Flash attention for Hopper (sm_90a): the forward and both backward kernels.
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//
//   fwd_mma_kernel (bf16), fwd_kernel (fp32)  <- _attn_kernel
//   dq_mma_kernel (bf16), dq_kernel (fp32)    <- _bwd_dq_kernel
//   dkv_mma_kernel (bf16), dkv_kernel (fp32)  <- _bwd_dkv_kernel
//
// Layout.  q, o, dO and dq are the model's [B, S, H, D]; k, v, dk and dv are
// [B, S, HK, D] (grouped-query attention, q-head h reads kv-head h / (H/HK));
// lse and delta are [B, H, S] fp32.  The kernels address the model layout
// through strides, so the port has none of the [B,S,H,D] <-> [B,H,S,D]
// transposes the Pallas wrapper makes.
//
// What bounds them.  Per (q, k) pair and head the forward does two
// D-deep products (4*D flops), dq three and dk/dv four, against O(S*D) bytes
// per head: at the training shape (S=2048, D=64) that is hundreds of flops
// per byte, far above the H100's ~295 bf16 flops/byte ridge.  All three are
// bound by tensor-core throughput (989 TFLOP/s dense bf16).
//
// The bf16 kernels (FlashAttention-2 style):
//   * eight warps per block; every warp owns 16 rows of its output tile and
//     runs mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with operands from
//     ldmatrix;
//   * scores, probabilities, the running max and sum and every accumulator
//     live in registers; a score tile's C fragments become, rounded to
//     bf16, the A fragments of the next product, so p and ds never touch
//     shared memory;
//   * the streamed operand (K/V tiles in the forward and dq; Q, dO, lse and
//     delta in dk/dv) arrives through a ring of cp.async stages, so the next
//     tile loads while this one computes; one __syncthreads per tile;
//   * shared rows are padded by 16 bytes, which keeps ldmatrix free of bank
//     conflicts;
//   * the forward's and dq's block is 128 q rows against 64-key tiles; dq
//     keeps its warp's Q and dO fragments, lse and delta in registers for
//     the whole kernel and walks each K/V tile in 16-key slices, so that
//     only 16 keys of S and dP are live; K is the B operand of both
//     S = Q K^T (ldmatrix) and dQ += dS K (ldmatrix.trans);
//   * dk/dv's block is 128 keys, which walks the group's q-heads in 32-row
//     q steps and computes the transposed scores (K Q^T) so that P^T and
//     dS^T are A fragments of dV += P^T dO and dK += dS^T Q;
//   * one block writes each dq and each dk/dv tile once (dk/dv summing the
//     GQA group in fp32 registers): no atomics, bitwise deterministic.
// The fp32 kernels are the first, simple versions: every intermediate in
// shared memory, loads not pipelined, exact scalar FMAs (tensor cores would
// round fp32 inputs to TF32).
//
// All follow the Pallas kernels' causal cases (tiles below the diagonal
// unmasked, tiles on it masked with NEG_INF = -1e30, tiles above it skipped;
// in the bf16 kernels a warp also skips a tile its rows never reach) and
// launch the tiles with the most work first.  The dtype discipline is the
// Pallas kernels': q.k^T accumulates in fp32 and the scale multiplies the
// fp32 product (the bf16 kernels fold log2(e) into it and take 2^x on the
// special-function unit; lse is written in natural log); p and ds are
// rounded to the input dtype before they enter a product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;  // threads per block of the simple kernels: four warps
constexpr int NWARPS = NT / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int PAD = 8;  // row padding (elements) of every shared tile

// Rows of a q tile (M) and of a kv tile (N) of the simple fp32 kernels,
// small enough that their fp32 buffers fit in shared memory at D = 128.
struct F32Tile { static constexpr int M = 32, N = 32; };

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory carving, 128-byte aligned; the host sums the same sizes.
__host__ __device__ constexpr size_t rnd(size_t b) { return (b + 127) / 128 * 128; }
template <typename U> __host__ __device__ constexpr size_t buf(int rows, int cols) {
  return rnd(sizeof(U) * (size_t)rows * (size_t)(cols + PAD));
}
struct Carve {
  char* p;
  template <typename U> __device__ U* take(int rows, int cols) {
    U* r = reinterpret_cast<U*>(p);
    p += buf<U>(rows, cols);
    return r;
  }
};

// C[M x N] (row pitch ldc) = or += A[M x K] * B[K x N], fp32, all in shared
// memory, with exact scalar FMAs.  A_T: A is stored transposed (A[i][k] at
// a[k*lda + i]); B_T: B is stored transposed (B[k][j] at b[j*ldb + k]).
template <int M, int N, int K, bool A_T, bool B_T>
__device__ void gemm(float* C, int ldc, const float* A, int lda, const float* B, int ldb,
                     bool accumulate) {
  for (int idx = threadIdx.x; idx < M * N; idx += NT) {
    const int i = idx / N, j = idx % N;
    float s = accumulate ? C[i * ldc + j] : 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = A_T ? A[k * lda + i] : A[i * lda + k];
      const float b = B_T ? B[j * ldb + k] : B[k * ldb + j];
      s = fmaf(a, b, s);
    }
    C[i * ldc + j] = s;
  }
}

// ROWS x W fp32 tile from global memory (row stride `stride` elements) into
// shared memory (row pitch W + PAD), 16 bytes per thread per step.
template <int ROWS, int W>
__device__ void load_tile(float* dst, const float* __restrict__ src, long stride) {
  constexpr int PER = W / 4;
  for (int i = threadIdx.x; i < ROWS * PER; i += NT) {
    const int r = i / PER, c = (i - r * PER) * 4;
    *reinterpret_cast<float4*>(dst + r * (W + PAD) + c) =
        __ldg(reinterpret_cast<const float4*>(src + (long)r * stride + c));
  }
}

template <int ROWS, int W>
__device__ void zero_tile(float* dst) {
  for (int i = threadIdx.x; i < ROWS * (W + PAD); i += NT) dst[i] = 0.0f;
}

// Shared tile times `mul` into global memory.
template <int ROWS, int W>
__device__ void store_tile(float* __restrict__ dst, long stride, const float* src, float mul) {
  for (int i = threadIdx.x; i < ROWS * W; i += NT) {
    const int r = i / W, c = i % W;
    dst[(long)r * stride + c] = src[r * (W + PAD) + c] * mul;
  }
}

// ------------------------------------------------- fp32 forward (simple)
template <int D>
constexpr size_t fwd_smem() {
  using T = float;
  constexpr int BM = F32Tile::M, BN = F32Tile::N;
  return buf<T>(BM, D) + 2 * buf<T>(BN, D) + buf<float>(BM, BN) + buf<T>(BM, BN) +
         buf<float>(BM, D) + 2 * rnd(sizeof(float) * BM);
}

template <int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
           int S, int H, int HK, int causal, float scale) {
  using T = float;
  constexpr int BM = F32Tile::M, BN = F32Tile::N;
  constexpr int PD = D + PAD, PN = BN + PAD;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sQ = cv.take<T>(BM, D);
  T* sK = cv.take<T>(BN, D);
  T* sV = cv.take<T>(BN, D);
  float* sS = cv.take<float>(BM, BN);
  T* sP = cv.take<T>(BM, BN);
  float* sO = cv.take<float>(BM, D);
  float* sM = reinterpret_cast<float*>(cv.p);
  float* sL = sM + rnd(sizeof(float) * BM) / sizeof(float);

  const int qt = gridDim.x - 1 - blockIdx.x;  // most causal work first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HK);
  const int q0 = qt * BM;
  const long qs = (long)H * D, ks = (long)HK * D;
  const T* kb = k + (long)b * S * ks + (long)hk * D;
  const T* vb = v + (long)b * S * ks + (long)hk * D;

  load_tile<BM, D>(sQ, q + ((long)b * S + q0) * qs + (long)h * D, qs);
  zero_tile<BM, D>(sO);
  for (int r = threadIdx.x; r < BM; r += NT) {
    sM[r] = NEG_INF;
    sL[r] = 0.0f;
  }

  const int n_kv = causal ? min(S / BN, (q0 + BM + BN - 1) / BN) : S / BN;
  const int n_full = causal ? q0 / BN : n_kv;  // tiles wholly below the diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's readers of sK, sV, sP are done
    load_tile<BN, D>(sK, kb + (long)k0 * ks, ks);
    load_tile<BN, D>(sV, vb + (long)k0 * ks, ks);
    __syncthreads();
    gemm<BM, BN, D, false, true>(sS, PN, sQ, PD, sK, PD, false);  // S = Q K^T
    __syncthreads();
    const bool masked = j >= n_full;
    for (int r = warp; r < BM; r += NWARPS) {  // one warp per row
      float* srow = sS + r * PN;
      const int qpos = q0 + r;
      float mx = NEG_INF;
      for (int c = lane; c < BN; c += 32) {
        float s = srow[c] * scale;
        if (masked && qpos < k0 + c) s = NEG_INF;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < BN; c += 32) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        sP[r * PN + c] = p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      float* orow = sO + r * PD;
      for (int c = lane; c < D; c += 32) orow[c] *= alpha;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncthreads();
    gemm<BM, D, BN, false, false>(sO, PD, sP, PN, sV, PD, true);  // O += P V
  }
  __syncthreads();
  T* ob = o + ((long)b * S + q0) * qs + (long)h * D;
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    const int r = i / D, c = i % D;
    ob[(long)r * qs + c] = sO[r * PD + c] / fmaxf(sL[r], 1e-30f);
  }
  for (int r = threadIdx.x; r < BM; r += NT)
    lse[((long)b * H + h) * S + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
}

// ------------------------------------------------------ fp32 dq (simple)
template <int D>
constexpr size_t dq_smem() {
  using T = float;
  constexpr int BM = F32Tile::M, BN = F32Tile::N;
  return 2 * buf<T>(BM, D) + 2 * buf<T>(BN, D) + 2 * buf<float>(BM, BN) + buf<T>(BM, BN) +
         buf<float>(BM, D) + 2 * rnd(sizeof(float) * BM);
}

template <int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int H, int HK, int causal, float scale) {
  using T = float;
  constexpr int BM = F32Tile::M, BN = F32Tile::N;
  constexpr int PD = D + PAD, PN = BN + PAD;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sQ = cv.take<T>(BM, D);
  T* sdO = cv.take<T>(BM, D);
  T* sK = cv.take<T>(BN, D);
  T* sV = cv.take<T>(BN, D);
  float* sS = cv.take<float>(BM, BN);
  float* sdP = cv.take<float>(BM, BN);
  T* sdS = cv.take<T>(BM, BN);
  float* sdQ = cv.take<float>(BM, D);
  float* sLse = reinterpret_cast<float*>(cv.p);
  float* sDelta = sLse + rnd(sizeof(float) * BM) / sizeof(float);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HK);
  const int q0 = qt * BM;
  const long qs = (long)H * D, ks = (long)HK * D;
  const long qoff = ((long)b * S + q0) * qs + (long)h * D;
  const long roff = ((long)b * H + h) * S + q0;
  const T* kb = k + (long)b * S * ks + (long)hk * D;
  const T* vb = v + (long)b * S * ks + (long)hk * D;

  load_tile<BM, D>(sQ, q + qoff, qs);
  load_tile<BM, D>(sdO, dout + qoff, qs);
  zero_tile<BM, D>(sdQ);
  for (int r = threadIdx.x; r < BM; r += NT) {
    sLse[r] = lse[roff + r];
    sDelta[r] = delta[roff + r];
  }

  const int n_kv = causal ? min(S / BN, (q0 + BM + BN - 1) / BN) : S / BN;
  const int n_full = causal ? q0 / BN : n_kv;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_tile<BN, D>(sK, kb + (long)k0 * ks, ks);
    load_tile<BN, D>(sV, vb + (long)k0 * ks, ks);
    __syncthreads();
    gemm<BM, BN, D, false, true>(sS, PN, sQ, PD, sK, PD, false);    // S = Q K^T
    gemm<BM, BN, D, false, true>(sdP, PN, sdO, PD, sV, PD, false);  // dP = dO V^T
    __syncthreads();
    const bool masked = j >= n_full;
    for (int i = threadIdx.x; i < BM * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      float s = sS[r * PN + c] * scale;
      if (masked && q0 + r < k0 + c) s = NEG_INF;
      const float p = expf(s - sLse[r]);
      sdS[r * PN + c] = p * (sdP[r * PN + c] - sDelta[r]);
    }
    __syncthreads();
    gemm<BM, D, BN, false, false>(sdQ, PD, sdS, PN, sK, PD, true);  // dQ += dS K
  }
  __syncthreads();
  store_tile<BM, D>(dq + qoff, qs, sdQ, scale);
}

// ---------------------------------------------------- fp32 dk/dv (simple)
template <int D>
constexpr size_t dkv_smem() {
  using T = float;
  constexpr int BM = F32Tile::M, BN = F32Tile::N;
  return 2 * buf<T>(BN, D) + 2 * buf<T>(BM, D) + 2 * buf<float>(BM, BN) +
         2 * buf<T>(BM, BN) + 2 * buf<float>(BN, D) + 2 * rnd(sizeof(float) * BM);
}

template <int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int S, int H, int HK, int causal,
           float scale) {
  using T = float;
  constexpr int BM = F32Tile::M, BN = F32Tile::N;
  constexpr int PD = D + PAD, PN = BN + PAD;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sK = cv.take<T>(BN, D);
  T* sV = cv.take<T>(BN, D);
  T* sQ = cv.take<T>(BM, D);
  T* sdO = cv.take<T>(BM, D);
  float* sS = cv.take<float>(BM, BN);
  float* sdP = cv.take<float>(BM, BN);
  T* sP = cv.take<T>(BM, BN);
  T* sdS = cv.take<T>(BM, BN);
  float* sdK = cv.take<float>(BN, D);
  float* sdV = cv.take<float>(BN, D);
  float* sLse = reinterpret_cast<float*>(cv.p);
  float* sDelta = sLse + rnd(sizeof(float) * BM) / sizeof(float);

  const int kt = blockIdx.x;  // low k tiles see the most q tiles: first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / HK;
  const int k0 = kt * BN;
  const long qs = (long)H * D, ks = (long)HK * D;
  const long koff = ((long)b * S + k0) * ks + (long)hk * D;

  load_tile<BN, D>(sK, k + koff, ks);
  load_tile<BN, D>(sV, v + koff, ks);
  zero_tile<BN, D>(sdK);
  zero_tile<BN, D>(sdV);

  const int qt_lo = causal ? k0 / BM : 0;  // q tiles wholly before this k tile add nothing
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = qt_lo; qt < S / BM; ++qt) {
      const int q0 = qt * BM;
      const long qoff = ((long)b * S + q0) * qs + (long)h * D;
      const long roff = ((long)b * H + h) * S + q0;
      __syncthreads();
      load_tile<BM, D>(sQ, q + qoff, qs);
      load_tile<BM, D>(sdO, dout + qoff, qs);
      for (int r = threadIdx.x; r < BM; r += NT) {
        sLse[r] = lse[roff + r];
        sDelta[r] = delta[roff + r];
      }
      __syncthreads();
      gemm<BM, BN, D, false, true>(sS, PN, sQ, PD, sK, PD, false);    // S = Q K^T
      gemm<BM, BN, D, false, true>(sdP, PN, sdO, PD, sV, PD, false);  // dP = dO V^T
      __syncthreads();
      const bool masked = causal && q0 < k0 + BN;  // tile crosses the diagonal
      for (int i = threadIdx.x; i < BM * BN; i += NT) {
        const int r = i / BN, c = i % BN;
        float s = sS[r * PN + c] * scale;
        if (masked && q0 + r < k0 + c) s = NEG_INF;
        const float p = expf(s - sLse[r]);
        sP[r * PN + c] = p;
        sdS[r * PN + c] = p * (sdP[r * PN + c] - sDelta[r]);
      }
      __syncthreads();
      gemm<BN, D, BM, true, false>(sdV, PD, sP, PN, sdO, PD, true);  // dV += P^T dO
      gemm<BN, D, BM, true, false>(sdK, PD, sdS, PN, sQ, PD, true);  // dK += dS^T Q
    }
  }
  __syncthreads();
  store_tile<BN, D>(dk + koff, ks, sdK, scale);
  store_tile<BN, D>(dv + koff, ks, sdV, 1.0f);
}

// ------------------------------------------- bf16 tensor-core primitives
// mma.sync.m16n8k16 fragments (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A 16x16 row-major, four b32 registers of two bf16: (g, 2t), (g+8, 2t),
//     (g, 2t+8), (g+8, 2t+8) and the next column of each;
//   B 16x8, two registers: (k = 2t, n = g), (k = 2t+8, n = g) and k + 1;
//   C 16x8 fp32, four registers: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
constexpr int MMA_THREADS = 256;  // eight warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a * [b0 b1]
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded (to nearest even) into one register of bf16: the
// first in the low half, as an mma operand wants the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 tile at `s` (row pitch P elements).
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int lane) {
  ldsm_x4(a, s + (lane & 15) * P + (lane >> 4) * 8);
}
// B fragments of two n-tiles from an operand stored [n][k]: rows n..n+15 at
// `s`, k columns 0..15.  {b[0], b[1]} feed n-tile 0, {b[2], b[3]} n-tile 1.
template <int P>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* s, int lane) {
  ldsm_x4(b, s + ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8);
}
// The same from an operand stored [k][n]: rows k..k+15 at `s`, n columns
// 0..15 (ldmatrix .trans).
template <int P>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* s, int lane) {
  ldsm_x4_t(b, s + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8);
}

// A fragment (16 rows x 16 columns, bf16) from the C fragments of n-tiles
// 2j and 2j+1: what makes a score tile the left operand of the next product
// without leaving registers.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x on the special-function unit.  -1e30 (a masked score) gives 0;
// results under 2^-126 flush to 0, far below what a bf16 product or an fp32
// sum of terms near 1 can hold.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ROWS x D bf16 rows from global memory (row stride `stride` elements) into
// shared memory (row pitch D + PAD) with cp.async, 16 bytes per copy.
template <int D>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, long stride, int rows) {
  constexpr int PER = D / 8;
  for (int i = threadIdx.x; i < rows * PER; i += MMA_THREADS) {
    const int r = i / PER, c = (i - r * PER) * 8;
    cp_async16(dst + r * (D + PAD) + c, src + (long)r * stride + c);
  }
}

// One warp's 16 x D fp32 accumulator times `mul`, rounded to bf16, staged
// through the warp's own 16 shared rows `stage` and written with 16-byte
// stores to global rows at `dst` (row stride `stride`).
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long stride, bf16* stage,
                                           const float (&acc)[D / 8][4], float mul0,
                                           float mul1, int lane) {
  constexpr int P = D + PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * P + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * P + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * mul1, acc[n][3] * mul1);
  }
  __syncwarp();
  constexpr int PER = D / 8;
  for (int i = lane; i < 16 * PER; i += 32) {
    const int r = i / PER, c = (i - r * PER) * 8;
    *reinterpret_cast<uint4*>(dst + (long)r * stride + c) =
        *reinterpret_cast<const uint4*>(stage + r * P + c);
  }
}

// ------------------------------------------------------- bf16 forward
// Block: 128 q rows (eight warps of 16) of one head; 64-key K/V tiles
// through a two-stage cp.async ring.  Per warp: S (16 x 64), O (16 x D),
// row max and sum in registers; Q fragments are read from shared memory at
// each k step (holding all of them would spill at 128 registers).
struct FwdTile { static constexpr int M = 128, N = 64, STAGES = 2; };

template <int D>
constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (size_t)(D + PAD) * (FwdTile::M + FwdTile::STAGES * 2 * FwdTile::N);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int S, int H, int HK, int causal, float scale) {
  constexpr int BM = FwdTile::M, BN = FwdTile::N, P = D + PAD, KD = D / 16;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BM * P;  // stage s: K at sKV + 2*s*BN*P, V after it

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // most causal work first
  const int hk = h / (H / HK);
  const int q0 = qt * BM;
  const int rows = min(BM, S - q0);  // a multiple of 64: the last tile may be half
  const long qs = (long)H * D, ks = (long)HK * D;
  const bf16* kb = k + (long)b * S * ks + (long)hk * D;
  const bf16* vb = v + (long)b * S * ks + (long)hk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16;  // this warp's first q row
  const bool active = w0 < S;

  auto load_kv = [&](int j) {
    bf16* st = sKV + (j % FwdTile::STAGES) * 2 * BN * P;
    cp_rows<D>(st, kb + (long)j * BN * ks, ks, BN);
    cp_rows<D>(st + BN * P, vb + (long)j * BN * ks, ks, BN);
  };
  cp_rows<D>(sQ, q + ((long)b * S + q0) * qs + (long)h * D, qs, rows);
  load_kv(0);
  cp_async_commit();

  const int n_kv = causal ? (q0 + rows) / BN : S / BN;
  const float scale2 = scale * LOG2E;
  bf16* const sQw = sQ + warp * 16 * P;  // this warp's rows
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of the scaled scores, log2 units
  float l[2] = {0.0f, 0.0f};        // this thread's part of the running sum

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<0>();  // tile j (and, for j = 0, Q) has landed
    __syncthreads();     // for every thread; tile j-1's stage is free
    if (j + 1 < n_kv) load_kv(j + 1);
    cp_async_commit();
    const int k0 = j * BN;
    if (!active || (causal && w0 + 15 < k0)) continue;  // every key follows every row
    const bf16* sK = sKV + (j % FwdTile::STAGES) * 2 * BN * P;
    const bf16* sV = sK + BN * P;

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4];
      load_a<P>(qa, sQw + kd * 16, lane);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        uint32_t bk[4];
        load_b_nk<P>(bk, sK + n * 16 * P + kd * 16, lane);
        mma16816(s[2 * n], qa, bk[0], bk[1]);
        mma16816(s[2 * n + 1], qa, bk[2], bk[3]);
      }
    }

    // online softmax; `masked` tiles cross the diagonal, and there a score
    // whose key follows its row becomes NEG_INF after the scale
    auto softmax = [&](auto masked) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if constexpr (decltype(masked)::value) {
            if (w0 + g + (e >> 1) * 8 < k0 + n * 8 + 2 * t + (e & 1)) x = NEG_INF;
            s[n][e] = x;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2_approx(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = decltype(masked)::value
                              ? exp2_approx(s[n][e] - m[e >> 1])
                              : exp2_approx(fmaf(s[n][e], scale2, -m[e >> 1]));
          l[e >> 1] += p;  // the sum takes p in fp32; P V takes it in bf16
          s[n][e] = p;
        }
      }
    };
    if (causal && k0 + BN - 1 > w0)  // some key follows some row
      softmax(std::true_type());
    else
      softmax(std::false_type());

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {  // O += P V
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bv[4];
        load_b_kn<P>(bv, sV + kk * 16 * P + n * 16, lane);
        mma16816(acc[2 * n], pa, bv[0], bv[1]);
        mma16816(acc[2 * n + 1], pa, bv[2], bv[3]);
      }
    }
  }
  if (!active) return;

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  // each warp reads only its own rows of sQ, so it may reuse them as staging
  store_rows<D>(o + ((long)b * S + w0) * qs + (long)h * D, qs, sQw, acc,
                1.0f / l0, 1.0f / l1, lane);
  if (t == 0) {
    float* lb = lse + ((long)b * H + h) * S + w0;
    lb[g] = m[0] * LN2 + logf(l0);  // natural log, as _attn_kernel writes it
    lb[g + 8] = m[1] * LN2 + logf(l1);
  }
}

// ------------------------------------------------------------- bf16 dq
// Block: 128 q rows (eight warps of 16) of one head; 64-key K/V tiles
// through a two-stage cp.async ring.  Per warp, for the whole kernel: the Q
// and dO A fragments of its rows, the dQ accumulator (16 x D, fp32), and
// each thread's lse (in log2 units) and delta of its two rows, all in
// registers.  A K/V tile is walked in 16-key slices: S = Q K^T and
// dP = dO V^T of the slice (16 x 16 each), P and dS formed in place, and
// dS, rounded to bf16, is at once the A fragment of dQ += dS K.
struct DqTile { static constexpr int M = 128, N = 64, STAGES = 2; };

template <int D>
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (size_t)(D + PAD) * (2 * DqTile::M + DqTile::STAGES * 2 * DqTile::N);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int H, int HK, int causal, float scale) {
  constexpr int BM = DqTile::M, BN = DqTile::N, NS = DqTile::STAGES;
  constexpr int P = D + PAD, KD = D / 16;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BM * P;
  bf16* sKV = sdO + BM * P;  // stage s: K at sKV + 2*s*BN*P, V after it

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // most causal work first
  const int hk = h / (H / HK);
  const int q0 = qt * BM;
  const int rows = min(BM, S - q0);  // a multiple of 64: the last tile may be half
  const long qs = (long)H * D, ks = (long)HK * D;
  const long qoff = ((long)b * S + q0) * qs + (long)h * D;
  const bf16* kb = k + (long)b * S * ks + (long)hk * D;
  const bf16* vb = v + (long)b * S * ks + (long)hk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16;  // this warp's first q row
  const bool active = w0 < S;

  const int n_kv = causal ? (q0 + rows) / BN : S / BN;
  auto load_kv = [&](int j) {
    bf16* st = sKV + (j % NS) * 2 * BN * P;
    cp_rows<D>(st, kb + (long)j * BN * ks, ks, BN);
    cp_rows<D>(st + BN * P, vb + (long)j * BN * ks, ks, BN);
  };
  cp_rows<D>(sQ, q + qoff, qs, rows);
  cp_rows<D>(sdO, dout + qoff, qs, rows);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // Q and dO ride with tile 0
    if (i < n_kv) load_kv(i);
    cp_async_commit();
  }

  // lse arrives in natural log: to log2 units, as the scores are scaled
  float lse2[2] = {0.0f, 0.0f}, dl[2] = {0.0f, 0.0f};
  if (active) {
    const long roff = ((long)b * H + h) * S + w0 + g;
    lse2[0] = lse[roff] * LOG2E;
    lse2[1] = lse[roff + 8] * LOG2E;
    dl[0] = delta[roff];
    dl[1] = delta[roff + 8];
  }
  const float scale2 = scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  cp_async_wait<NS - 2>();  // Q and dO have landed
  __syncthreads();          // for every thread
  uint32_t qa[KD][4], oa[KD][4];
  if (active) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      load_a<P>(qa[kd], sQ + warp * 16 * P + kd * 16, lane);
      load_a<P>(oa[kd], sdO + warp * 16 * P + kd * 16, lane);
    }
  }

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<NS - 2>();  // tile j has landed
    __syncthreads();          // for every thread; tile j-1's stage is free
    if (j + NS - 1 < n_kv) load_kv(j + NS - 1);
    cp_async_commit();
    if (!active) continue;
    const int k0 = j * BN;
    const bf16* sK = sKV + (j % NS) * 2 * BN * P;
    const bf16* sV = sK + BN * P;

#pragma unroll
    for (int sl = 0; sl < BN / 16; ++sl) {
      const int ks0 = k0 + sl * 16;  // the slice's first key; w0 is a multiple of 16
      if (causal && ks0 > w0) break;  // every key of this slice and the next follows every row
      const bf16* sKs = sK + sl * 16 * P;
      const bf16* sVs = sV + sl * 16 * P;

      // S = Q K^T and dP = dO V^T: n-tile 0 is keys 0-7 of the slice, 1 keys 8-15
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t bk[4], bv[4];
        load_b_nk<P>(bk, sKs + kd * 16, lane);
        load_b_nk<P>(bv, sVs + kd * 16, lane);
        mma16816(s[0], qa[kd], bk[0], bk[1]);
        mma16816(s[1], qa[kd], bk[2], bk[3]);
        mma16816(dp[0], oa[kd], bv[0], bv[1]);
        mma16816(dp[1], oa[kd], bv[2], bv[3]);
      }

      // P = 2^(s * scale2 - lse2) and dS = P (dP - delta), into dp; on the
      // `masked` slice (the warp's diagonal) a score whose key follows its
      // row becomes NEG_INF after the scale
      auto probs = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p;
            if constexpr (decltype(masked)::value) {
              float x = s[n][e] * scale2;
              if (w0 + g + (e >> 1) * 8 < ks0 + n * 8 + 2 * t + (e & 1)) x = NEG_INF;
              p = exp2_approx(x - lse2[e >> 1]);
            } else {
              p = exp2_approx(fmaf(s[n][e], scale2, -lse2[e >> 1]));
            }
            dp[n][e] = p * (dp[n][e] - dl[e >> 1]);
          }
        }
      };
      if (causal && ks0 == w0)
        probs(std::true_type());
      else
        probs(std::false_type());

      // dQ += dS K: K stored [key][d] is the [k][n] operand
      uint32_t da[4];
      c_to_a(da, dp[0], dp[1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bk[4];
        load_b_kn<P>(bk, sKs + n * 16, lane);
        mma16816(acc[2 * n], da, bk[0], bk[1]);
        mma16816(acc[2 * n + 1], da, bk[2], bk[3]);
      }
    }
  }
  if (!active) return;
  // each warp reads only its own rows of sQ, so it may reuse them as staging
  store_rows<D>(dq + qoff + (long)warp * 16 * qs, qs, sQ + warp * 16 * P, acc, scale, scale,
                lane);
}

// --------------------------------------------------------- bf16 dk/dv
// Block: 128 keys (eight warps of 16) of one kv-head, which walks the
// group's q-heads in 32-row q steps; Q, dO, lse and delta of a step arrive
// through a three-stage cp.async ring.  Per warp: S^T and dP^T (16 x 32) and
// the dK, dV accumulators (16 x D) in registers; K and V fragments are read
// from shared memory at each step.
struct DkvTile { static constexpr int N = 128, M = 32, STAGES = 3; };

template <int D>
__host__ __device__ constexpr size_t dkv_stage_bytes() {  // Q, dO, lse, delta of one q step
  return sizeof(bf16) * 2 * DkvTile::M * (D + PAD) + sizeof(float) * 2 * DkvTile::M;
}
template <int D>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * 2 * DkvTile::N * (D + PAD) + DkvTile::STAGES * dkv_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int HK,
               int causal, float scale) {
  constexpr int BN = DkvTile::N, BM = DkvTile::M, NS = DkvTile::STAGES;
  constexpr int P = D + PAD, KD = D / 16;
  extern __shared__ __align__(128) char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * P;
  char* stages = reinterpret_cast<char*>(sV + BN * P);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z;  // low k tiles see the most q steps: first
  const int group = H / HK;
  const int k0 = kt * BN;
  const long qs = (long)H * D, ks = (long)HK * D;
  const long koff = ((long)b * S + k0) * ks + (long)hk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = k0 + warp * 16;  // this warp's first key
  const bool active = w0 < S;

  const int qt_lo = causal ? k0 / BM : 0;  // q steps wholly before this tile add nothing
  const int per_head = S / BM - qt_lo;
  const int n_steps = group * per_head;
  auto stage = [&](int i) { return stages + (i % NS) * dkv_stage_bytes<D>(); };
  auto load_step = [&](int i) {
    const int h = hk * group + i / per_head;
    const int q0 = (qt_lo + i % per_head) * BM;
    bf16* sQ = reinterpret_cast<bf16*>(stage(i));
    const long qoff = ((long)b * S + q0) * qs + (long)h * D;
    cp_rows<D>(sQ, q + qoff, qs, BM);
    cp_rows<D>(sQ + BM * P, dout + qoff, qs, BM);
    float* sL = reinterpret_cast<float*>(sQ + 2 * BM * P);
    const long roff = ((long)b * H + h) * S + q0;
    // the last 2 * BM / 4 threads copy lse then delta, 16 bytes each
    const int i4 = (int)threadIdx.x - MMA_THREADS + 2 * (BM / 4);
    if (i4 >= 0)
      cp_async16(sL + (i4 % (BM / 4)) * 4 + (i4 / (BM / 4)) * BM,
                 (i4 < BM / 4 ? lse : delta) + roff + (i4 % (BM / 4)) * 4);
  };
  const int keys = min(BN, S - k0);
  cp_rows<D>(sK, k + koff, ks, keys);
  cp_rows<D>(sV, v + koff, ks, keys);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // K, V ride with step 0
    if (i < n_steps) load_step(i);
    cp_async_commit();
  }

  const float scale2 = scale * LOG2E;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<NS - 2>();  // step i has landed
    __syncthreads();          // for every thread; step i-1's stage is free
    if (i + NS - 1 < n_steps) load_step(i + NS - 1);
    cp_async_commit();
    const int q0 = (qt_lo + i % per_head) * BM;
    if (!active || (causal && q0 + BM - 1 < w0)) continue;  // every key follows every row
    const bf16* sQ = reinterpret_cast<const bf16*>(stage(i));
    const bf16* sdO = sQ + BM * P;
    const float* sL = reinterpret_cast<const float*>(sQ + 2 * BM * P);
    const float* sDl = sL + BM;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x BM queries
    float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ka[4], va[4];
      load_a<P>(ka, sK + warp * 16 * P + kd * 16, lane);
      load_a<P>(va, sV + warp * 16 * P + kd * 16, lane);
#pragma unroll
      for (int n = 0; n < BM / 16; ++n) {
        uint32_t bq[4], bo[4];
        load_b_nk<P>(bq, sQ + n * 16 * P + kd * 16, lane);
        load_b_nk<P>(bo, sdO + n * 16 * P + kd * 16, lane);
        mma16816(st[2 * n], ka, bq[0], bq[1]);
        mma16816(st[2 * n + 1], ka, bq[2], bq[3]);
        mma16816(dpt[2 * n], va, bo[0], bo[1]);
        mma16816(dpt[2 * n + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp(s - lse) and dS^T = P^T (dP^T - delta), column q, row key;
    // on `masked` steps a score whose key follows its q becomes NEG_INF
    auto probs = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        const float2 lq = *reinterpret_cast<const float2*>(sL + n * 8 + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(sDl + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse2 = ((e & 1) ? lq.y : lq.x) * LOG2E;
          float p;
          if constexpr (decltype(masked)::value) {
            float x = st[n][e] * scale2;
            if (q0 + n * 8 + 2 * t + (e & 1) < w0 + g + (e >> 1) * 8) x = NEG_INF;
            p = exp2_approx(x - lse2);
          } else {
            p = exp2_approx(fmaf(st[n][e], scale2, -lse2));
          }
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - ((e & 1) ? dl.y : dl.x));
        }
      }
    };
    if (causal && q0 < w0 + 15)  // some key follows some q
      probs(std::true_type());
    else
      probs(std::false_type());

    // dV += P^T dO and dK += dS^T Q, over the BM queries of the step
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bo[4], bq[4];
        load_b_kn<P>(bo, sdO + kk * 16 * P + n * 16, lane);
        load_b_kn<P>(bq, sQ + kk * 16 * P + n * 16, lane);
        mma16816(dva[2 * n], pa, bo[0], bo[1]);
        mma16816(dva[2 * n + 1], pa, bo[2], bo[3]);
        mma16816(dka[2 * n], da, bq[0], bq[1]);
        mma16816(dka[2 * n + 1], da, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with sK and sV: they stage the output
  if (!active) return;
  store_rows<D>(dk + koff + (long)warp * 16 * ks, ks, sK + warp * 16 * P, dka, scale, scale,
                lane);
  store_rows<D>(dv + koff + (long)warp * 16 * ks, ks, sV + warp * 16 * P, dva, 1.0f, 1.0f,
                lane);
}

// ------------------------------------------------------------------ launches
// 1/sqrt(D) rounded once from double, as the JAX wrapper computes it.
float softmax_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The launch configuration of each kernel: its function, threads per block
// and dynamic shared memory.  `launch_*` launch it; `hvd_kernel_resources`
// reports it.
template <typename F> struct Config {
  F fn;
  int threads;
  size_t smem;
};

template <typename T, int D> auto fwd_config() {
  if constexpr (std::is_same<T, bf16>::value)
    return Config<decltype(&fwd_mma_kernel<D>)>{fwd_mma_kernel<D>, MMA_THREADS,
                                                fwd_mma_smem<D>()};
  else
    return Config<decltype(&fwd_kernel<D>)>{fwd_kernel<D>, NT, fwd_smem<D>()};
}
template <typename T, int D> auto dq_config() {
  if constexpr (std::is_same<T, bf16>::value)
    return Config<decltype(&dq_mma_kernel<D>)>{dq_mma_kernel<D>, MMA_THREADS,
                                               dq_mma_smem<D>()};
  else
    return Config<decltype(&dq_kernel<D>)>{dq_kernel<D>, NT, dq_smem<D>()};
}
template <typename T, int D> auto dkv_config() {
  if constexpr (std::is_same<T, bf16>::value)
    return Config<decltype(&dkv_mma_kernel<D>)>{dkv_mma_kernel<D>, MMA_THREADS,
                                                dkv_mma_smem<D>()};
  else
    return Config<decltype(&dkv_kernel<D>)>{dkv_kernel<D>, NT, dkv_smem<D>()};
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int S, int H, int HK, int causal, cudaStream_t st) {
  auto c = fwd_config<T, D>();
  cudaError_t e = allow_smem(c.fn, c.smem);
  if (e != cudaSuccess) return e;
  dim3 grid = std::is_same<T, bf16>::value ? dim3(H, B, cdiv(S, FwdTile::M))
                                           : dim3(S / F32Tile::M, H, B);
  c.fn<<<grid, c.threads, c.smem, st>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                        (float*)lse, S, H, HK, causal, softmax_scale(D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int S, int H,
                      int HK, int causal, cudaStream_t st) {
  auto c = dq_config<T, D>();
  cudaError_t e = allow_smem(c.fn, c.smem);
  if (e != cudaSuccess) return e;
  dim3 grid = std::is_same<T, bf16>::value ? dim3(H, B, cdiv(S, DqTile::M))
                                           : dim3(S / F32Tile::M, H, B);
  c.fn<<<grid, c.threads, c.smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                        (const T*)dout, (const float*)lse,
                                        (const float*)delta, (T*)dq, S, H, HK, causal,
                                        softmax_scale(D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                       int H, int HK, int causal, cudaStream_t st) {
  auto c = dkv_config<T, D>();
  cudaError_t e = allow_smem(c.fn, c.smem);
  if (e != cudaSuccess) return e;
  // all tiles of one k position together, lowest (most work) first
  dim3 grid = std::is_same<T, bf16>::value ? dim3(HK, B, cdiv(S, DkvTile::N))
                                           : dim3(S / F32Tile::N, HK, B);
  c.fn<<<grid, c.threads, c.smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                        (const T*)dout, (const float*)lse,
                                        (const float*)delta, (T*)dk, (T*)dv, S, H, HK, causal,
                                        softmax_scale(D));
  return cudaGetLastError();
}

// out: static and dynamic shared bytes per block, threads per block,
// resident blocks per SM.
template <typename C>
cudaError_t resources(C c, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = allow_smem(c.fn, c.smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, c.fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.fn, c.threads, c.smem);
  if (e != cudaSuccess) return e;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = (int)c.smem;
  out[2] = c.threads;
  out[3] = blocks;
  return cudaSuccess;
}

// Shapes the Python wrapper has validated: D in {32, 64, 128}, S a multiple
// of 64 (bf16: the forward's and dq's key tiles) or 32 (fp32), H a multiple
// of HK.
bool shape_ok(int S, int H, int HK, int D, int is_bf16) {
  const int tile = is_bf16 ? FwdTile::N : F32Tile::M;
  return (D == 32 || D == 64 || D == 128) && S > 0 && S % tile == 0 && HK > 0 &&
         H % HK == 0;
}

}  // namespace

#define HVD_DISPATCH_T(T, FN, ...)                          \
  switch (D) {                                              \
    case 32: return (int)FN<T, 32>(__VA_ARGS__);            \
    case 64: return (int)FN<T, 64>(__VA_ARGS__);            \
    default: return (int)FN<T, 128>(__VA_ARGS__);           \
  }
#define HVD_DISPATCH(FN, ...)                                \
  if (is_bf16) { HVD_DISPATCH_T(bf16, FN, __VA_ARGS__) }     \
  HVD_DISPATCH_T(float, FN, __VA_ARGS__)

extern "C" {

// Each returns a cudaError_t: 0 when the launch was accepted.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                  int S, int H, int HK, int D, int causal, int is_bf16, void* stream) {
  if (!shape_ok(S, H, HK, D, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(launch_fwd, q, k, v, o, lse, B, S, H, HK, causal, st)
}

int hvd_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int B, int S, int H,
                     int HK, int D, int causal, int is_bf16, void* stream) {
  if (!shape_ok(S, H, HK, D, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, S, H, HK, causal, st)
}

int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                      int H, int HK, int D, int causal, int is_bf16, void* stream) {
  if (!shape_ok(S, H, HK, D, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, S, H, HK, causal, st)
}

// The resources of one kernel instantiation (kernel: 0 forward, 1 dq,
// 2 dk/dv) on the current device, into out[4] (see `resources`).
int hvd_kernel_resources(int kernel, int D, int is_bf16, int* out) {
  if (kernel < 0 || kernel > 2 || (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
#define HVD_RES(T, DD)                                                    \
  return (int)(kernel == 0 ? resources(fwd_config<T, DD>(), out)         \
                           : kernel == 1 ? resources(dq_config<T, DD>(), out) \
                                         : resources(dkv_config<T, DD>(), out));
  if (is_bf16) {
    if (D == 32) { HVD_RES(bf16, 32) }
    if (D == 64) { HVD_RES(bf16, 64) }
    HVD_RES(bf16, 128)
  }
  if (D == 32) { HVD_RES(float, 32) }
  if (D == 64) { HVD_RES(float, 64) }
  HVD_RES(float, 128)
#undef HVD_RES
}

const char* hvd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
