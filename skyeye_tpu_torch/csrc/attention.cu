// Fused softmax attention for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernel in skyeye_tpu/ops/pallas/attention_kernel.py:
//   skyeye_flash_attention  <- flash_attention / _flash_kernel, as reached through
//                              padded_flash_attention (K4)
// o = softmax(q k^T * scale) v over (B, N, hd) float32, B = batch * heads. For any
// N and hd <= 256 it computes what padded_flash_attention returns after its
// padding and slicing: the key tail is masked here (score -1e30), and neither N
// nor hd is padded in device memory.
//
// Design: one block per (batch*head, tile of 64 query rows), 256 threads as a
// 16 x 16 grid. The block keeps its scaled query tile in shared memory and walks
// the keys in tiles of 64: K (transposed) and V are staged in shared memory, each
// thread computes a 4 x 4 patch of the score tile, the float32 online softmax
// (running max m, running sum l, rescale by exp(m_old - m_new)) runs on the
// patch with half-warp shuffles, the probabilities go to shared memory, and each
// thread accumulates a 4 x (hd / 16) patch of the output in registers. Scores
// never reach device memory. The output is acc / max(l, 1e-30), as on the TPU.
//
// Bound: at the serving shape (64, 1600, 256) the work is 4 N^2 hd flops per
// (batch*head), 168 GFLOP, 2.5 ms at the card's 67 TFLOP/s float32 rate, against
// 0.13 ms for the bytes; so it is bound by operations. This simple kernel uses
// the CUDA cores' FMAs and reads both operands of each product from shared
// memory (broadcast across the half-warp); tensor cores (TF32 or bf16 wgmma) and
// TMA are later work.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kKeys = kBK / 16;  // keys per thread in the score tile
constexpr int kLdk = kBK + 1;    // transposed K and P rows: odd, so no bank conflicts
constexpr int kMaxCols = 16;     // output columns per thread: hd <= 16 * kMaxCols
constexpr float kNegInf = -1e30f;

__host__ __device__ inline int ld_q(int hd) { return hd | 1; }  // odd row stride

size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * ld_q(hd)  // scaled q tile
                          + static_cast<size_t>(hd) * kLdk     // k tile, transposed
                          + static_cast<size_t>(kBK) * hd      // v tile
                          + static_cast<size_t>(kBQ) * kLdk);  // probabilities
}

template <int NC>  // output columns per thread: hd <= 16 * NC
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int n, int hd, float scale) {
  extern __shared__ float smem[];
  const int ldq = ld_q(hd);
  float* s_q = smem;                   // (kBQ, ldq)
  float* s_kt = s_q + kBQ * ldq;       // (hd, kLdk)
  float* s_v = s_kt + hd * kLdk;       // (kBK, hd)
  float* s_p = s_v + kBK * hd;         // (kBQ, kLdk)

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key / column lane within the half-warp
  const int ty = tid >> 4;   // owns query rows ty * kRows + i
  const size_t base = static_cast<size_t>(blockIdx.y) * n * hd;
  const int q0 = blockIdx.x * kBQ;

  // q tile, scaled as the TPU kernel scales it; rows past n are zero
  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    s_q[r * ldq + d] = (q0 + r < n) ? q[base + static_cast<size_t>(q0 + r) * hd + d] * scale
                                    : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int key = e / hd, d = e - key * hd;
      const bool in = k0 + key < n;
      const size_t g = base + static_cast<size_t>(k0 + key) * hd + d;
      s_kt[d * kLdk + key] = in ? k[g] : 0.f;
      s_v[key * hd + d] = in ? v[g] : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = s_q[(ty * kRows + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = s_kt[d * kLdk + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile; a row's 64 scores lie in one half-warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (k0 + tx + 16 * j >= n) s[i][j] = kNegInf;  // the key tail
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        s_p[(ty * kRows + i) * kLdk + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int key = 0; key < kBK; ++key) {
      float pv[kRows], vv[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = s_p[(ty * kRows + i) * kLdk + key];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < hd ? s_v[key * hd + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= n) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) o[base + static_cast<size_t>(r) * hd + c] = acc[i][j] * inv;
    }
  }
}

template <int NC>
int launch(const float* q, const float* k, const float* v, float* o, int batch, int n, int hd,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBQ - 1) / kBQ, batch);
  flash_attention_kernel<NC><<<grid, kThreads, smem, stream>>>(q, k, v, o, n, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, n, hd) float32, contiguous, on the device. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
int skyeye_flash_attention(const float* q, const float* k, const float* v, float* o, int batch,
                           int n, int hd, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || hd <= 0) return 0;
  if (hd > 16 * kMaxCols || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch<2>(q, k, v, o, batch, n, hd, scale, s);
  if (hd <= 64) return launch<4>(q, k, v, o, batch, n, hd, scale, s);
  if (hd <= 128) return launch<8>(q, k, v, o, batch, n, hd, scale, s);
  return launch<kMaxCols>(q, k, v, o, batch, n, hd, scale, s);
}

}  // extern "C"
