// Fused softmax attention for Hopper (sm_90a) on the TF32 tensor cores, behind a
// plain C interface.
//
// Replaces the Pallas TPU kernel in skyeye_tpu/ops/pallas/attention_kernel.py:
//   skyeye_flash_attention  <- flash_attention / _flash_kernel, as reached through
//                              padded_flash_attention (K4)
// o = softmax(q k^T * scale) v over (B, N, hd) float32, B = batch * heads. For any
// N and hd <= 256 it computes what padded_flash_attention returns after its
// padding and slicing: the key tail is masked here (score -1e30), and neither N
// nor hd is padded in device memory (hd is zero-padded to HD in shared memory).
//
// Bound: at the serving shape (64, 1600, 256) the work is 4 N^2 hd flops per
// (batch*head), 168 GFLOP. Float32 accuracy on TF32 tensor cores takes three
// products per product (below), so the least time is 3 * 168 GFLOP over the
// card's 495 TFLOP/s TF32 rate, 1.02 ms, against 0.13 ms for the bytes: the
// operations bound it.
//
// Design: one block of 8 warps per (batch*head, tile of 128 query rows); each
// warp owns 16 query rows. The block keeps its scaled query tile in shared
// memory and walks the keys in tiles of 32. Both products run as
// mma.sync.m16n8k8 TF32 with float32 sums:
//   S = q k^T: A = q (16 x 8 of hd), B = k^T (8 of hd x 8 keys);
//   O += P V:  A = P straight from S's accumulator registers, B = V.
// The mma's k index is free to permute in both products, so a thread reads
// q[row][2t, 2t+1] and k[key][2t, 2t+1] as float2, and P's accumulator pairs
// (keys 2t, 2t+1) are already the A fragment of the PV product when V's rows
// are read as 2t and 2t+1: no shuffles and no trip through shared memory.
// 3xTF32: each operand a is split as hi = a with its low 13 mantissa bits
// cleared (a TF32 value) and lo = tf32(a - hi), rounded from the exact rest, and
// a*b is summed as lo*hi + hi*lo + hi*hi (the small terms first), which keeps
// about 21 bits of each product against float32's 24. Consecutive mma's go to
// independent accumulators (each term over four n tiles in turn), so a warp
// does not wait on one mma's result to issue the next. The score product's precision
// is a compile-time choice (kScoreOnTensorCores): 3xTF32 on the tensor cores,
// or register-tiled float32 FMAs producing the same accumulator layout; the PV
// product is 3xTF32 either way. 3xTF32 is the default: held against einsums in
// float64 on the card (tools/attention_precision.py), it is as close as float32
// FMAs on the served inputs, and passes the large-logit tolerance on as many
// seeds; the error both builds share there comes from P V. The online softmax (running max m, running sum
// l, rescale by exp(m_old - m_new)) stays float32 in registers, one row's 32
// scores spread over the 4 threads of a quad.
//
// Staging: K and V tiles arrive by cp.async (16 bytes a thread where hd % 4 ==
// 0, else 4) into one buffer each, staggered: V(j) lands while S(j) is computed
// and K(j+1) lands while P(j) V(j) is, so every copy overlaps a product. Keys
// and query rows past N are zero-filled by the copy; the padded columns hd..HD
// are zeroed once. Row strides are HD + 8 floats (q, k: float2 reads conflict
// free) and HD + 4 (v: rows 2t and columns g spread over all 32 banks).
//
// Registers at HD 256: the output accumulator of a warp's 16 x 256 tile is 128
// a thread, the score tile 16, the split fragments 12 at a time; at one block
// of 256 threads per SM the budget is 255. ptxas's report (chip_smoke.py's
// build line) shows the count and that nothing spills. Shared memory at HD 256:
// q 135 KB + k 34 KB + v 33 KB = 202 KB. The attribute that allows it is set
// once per process and device for each instantiation.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>

#ifndef SKYEYE_SCORE_FP32
constexpr bool kScoreOnTensorCores = true;   // 3xTF32 q k^T
#else
constexpr bool kScoreOnTensorCores = false;  // float32 FMAs for q k^T
#endif

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 32;           // keys per tile
constexpr int kMaxHeadDim = 256;
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;

template <int HD> __host__ __device__ constexpr int ld_qk() { return HD + 8; }
template <int HD> __host__ __device__ constexpr int ld_v() { return HD + 4; }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * ld_qk<HD>() +
                          static_cast<size_t>(kBK) * ld_qk<HD>() +
                          static_cast<size_t>(kBK) * ld_v<HD>());
}

// x = hi + lo, each a TF32 value in a float32 register: hi is x truncated to
// TF32 (x - hi is exact), lo is that rest rounded to TF32, to nearest with ties
// away from zero as cvt.rna.tf32 rounds, but by an integer add and mask: half a
// TF32 ulp added to the magnitude carries into the kept bits exactly when the
// dropped ones are at least half (and into the exponent when the mantissa
// overflows). Two simple operations in place of cvt.rna's longer sequence;
// every split of both products goes through here.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// register-only: not volatile, so the compiler may interleave independent mma's
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[u] += a * b[u] for four n tiles in 3xTF32: each term over the four tiles in
// turn, the two cross terms first and the large one last
__device__ __forceinline__ void mma_3xtf32_x4(float (&d0)[4], float (&d1)[4], float (&d2)[4],
                                              float (&d3)[4], const uint32_t (&a_hi)[4],
                                              const uint32_t (&a_lo)[4],
                                              const uint32_t (&b_hi)[4][2],
                                              const uint32_t (&b_lo)[4][2]) {
  mma_tf32(d0, a_lo, b_hi[0]);
  mma_tf32(d1, a_lo, b_hi[1]);
  mma_tf32(d2, a_lo, b_hi[2]);
  mma_tf32(d3, a_lo, b_hi[3]);
  mma_tf32(d0, a_hi, b_lo[0]);
  mma_tf32(d1, a_hi, b_lo[1]);
  mma_tf32(d2, a_hi, b_lo[2]);
  mma_tf32(d3, a_hi, b_lo[3]);
  mma_tf32(d0, a_hi, b_hi[0]);
  mma_tf32(d1, a_hi, b_hi[1]);
  mma_tf32(d2, a_hi, b_hi[2]);
  mma_tf32(d3, a_hi, b_hi[3]);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid, bool vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? (vec ? 16 : 4) : 0;  // 0: fill with zeros
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + rows) x columns [0, hd) of a (n, hd) matrix into a tile of
// row stride ld; rows past n are zero-filled
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int row0,
                                          int rows, int n, int hd, bool vec) {
  const int step = vec ? 4 : 1;
  const int per_row = hd / step;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * step;
    const bool valid = row0 + r < n;
    const float* g = src + static_cast<size_t>(valid ? row0 + r : 0) * hd + c;
    cp_async(dst + r * ld + c, g, valid, vec);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int n, int hd,
                       float scale) {
  constexpr int LDQ = ld_qk<HD>(), LDK = ld_qk<HD>(), LDV = ld_v<HD>();
  constexpr int NT_O = HD / 8;   // output column tiles of 8
  constexpr int NT_S = kBK / 8;  // key tiles of 8 in a score tile
  static_assert(NT_S == 4 && NT_O % 4 == 0, "the products go four n tiles at a time");
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;              // (kBQ, LDQ)
  float* s_k = s_q + kBQ * LDQ;   // (kBK, LDK)
  float* s_v = s_k + kBK * LDK;   // (kBK, LDV)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group
  const size_t base = static_cast<size_t>(blockIdx.y) * n * hd;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const int q0 = blockIdx.x * kBQ;
  const int r0 = warp * 16;                // the warp's first row in the tile
  const bool active = q0 + r0 < n;         // a warp wholly past n skips the products
  const bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int tiles = (n + kBK - 1) / kBK;

  // the padded columns hd..HD are never copied: zero them once
  if (hd < HD) {
    for (int e = tid; e < kBQ * (HD - hd); e += kThreads)
      s_q[(e / (HD - hd)) * LDQ + hd + e % (HD - hd)] = 0.f;
    for (int e = tid; e < kBK * (HD - hd); e += kThreads) {
      s_k[(e / (HD - hd)) * LDK + hd + e % (HD - hd)] = 0.f;
      s_v[(e / (HD - hd)) * LDV + hd + e % (HD - hd)] = 0.f;
    }
  }
  load_tile(s_q, LDQ, qb, q0, kBQ, n, hd, vec);
  cp_async_commit();
  load_tile(s_k, LDK, kb, 0, kBK, n, hd, vec);
  cp_async_commit();
  load_tile(s_v, LDV, vb, 0, kBK, n, hd, vec);
  cp_async_commit();
  cp_async_wait<2>();  // this thread's q copies have landed
  __syncthreads();
  // scale q as the TPU kernel does, each thread the elements it copied
  {
    const int step = vec ? 4 : 1, per_row = hd / step;
    for (int e = tid; e < kBQ * per_row; e += kThreads) {
      const int r = e / per_row, c = (e - r * per_row) * step;
      for (int j = 0; j < step; ++j) s_q[r * LDQ + c + j] *= scale;
    }
  }

  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};  // rows g and g + 8

  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * kBK;
    cp_async_wait<1>();  // K(tile) has landed; V(tile) may be in flight
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (active) {
      if constexpr (kScoreOnTensorCores) {
        const float* q_lo = s_q + (r0 + g) * LDQ + 2 * t;  // row g; row g + 8 is 8 LDQ on
#pragma unroll 4
        for (int d0 = 0; d0 < HD; d0 += 8) {
          const float2 qa = *reinterpret_cast<const float2*>(q_lo + d0);
          const float2 qb2 = *reinterpret_cast<const float2*>(q_lo + 8 * LDQ + d0);
          uint32_t a_hi[4], a_lo[4];
          split(qa.x, a_hi[0], a_lo[0]);   // row g, logical k t     = dim 2t
          split(qb2.x, a_hi[1], a_lo[1]);  // row g + 8, logical k t
          split(qa.y, a_hi[2], a_lo[2]);   // row g, logical k t + 4 = dim 2t + 1
          split(qb2.y, a_hi[3], a_lo[3]);
          uint32_t b_hi[NT_S][2], b_lo[NT_S][2];
#pragma unroll
          for (int j = 0; j < NT_S; ++j) {
            const float2 kk =
                *reinterpret_cast<const float2*>(s_k + (8 * j + g) * LDK + d0 + 2 * t);
            split(kk.x, b_hi[j][0], b_lo[j][0]);
            split(kk.y, b_hi[j][1], b_lo[j][1]);
          }
          mma_3xtf32_x4(s[0], s[1], s[2], s[3], a_hi, a_lo, b_hi, b_lo);
        }
      } else {
        // float32 FMAs into the accumulator layout: this thread's scores are
        // rows g, g + 8 and keys 8 j + 2 t, 8 j + 2 t + 1
        const float* qr = s_q + (r0 + g) * LDQ;
#pragma unroll 2
        for (int d0 = 0; d0 < HD; d0 += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(qr + d0);
          const float4 qc = *reinterpret_cast<const float4*>(qr + 8 * LDQ + d0);
#pragma unroll
          for (int j = 0; j < NT_S; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float4 kk =
                  *reinterpret_cast<const float4*>(s_k + (8 * j + 2 * t + c) * LDK + d0);
              s[j][c] = fmaf(qa.x, kk.x, s[j][c]);
              s[j][c] = fmaf(qa.y, kk.y, s[j][c]);
              s[j][c] = fmaf(qa.z, kk.z, s[j][c]);
              s[j][c] = fmaf(qa.w, kk.w, s[j][c]);
              s[j][2 + c] = fmaf(qc.x, kk.x, s[j][2 + c]);
              s[j][2 + c] = fmaf(qc.y, kk.y, s[j][2 + c]);
              s[j][2 + c] = fmaf(qc.z, kk.z, s[j][2 + c]);
              s[j][2 + c] = fmaf(qc.w, kk.w, s[j][2 + c]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with K(tile)
    if (tile + 1 < tiles) load_tile(s_k, LDK, kb, k0 + kBK, kBK, n, hd, vec);
    cp_async_commit();

    if (active) {
      // the key tail, then the online softmax of rows g (c0, c1) and g + 8 (c2, c3)
      if (k0 + kBK > n) {
#pragma unroll
        for (int j = 0; j < NT_S; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k0 + 8 * j + 2 * t + (c & 1) >= n) s[j][c] = kNegInf;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NT_S; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_row[h], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
          s[j][2 * h] = expf(s[j][2 * h] - m_new);
          s[j][2 * h + 1] = expf(s[j][2 * h + 1] - m_new);
          sum += s[j][2 * h] + s[j][2 * h + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float alpha = expf(m_row[h] - m_new);
        l_row[h] = l_row[h] * alpha + sum;
        m_row[h] = m_new;
#pragma unroll
        for (int j = 0; j < NT_O; ++j) {
          acc[j][2 * h] *= alpha;
          acc[j][2 * h + 1] *= alpha;
        }
      }
    }

    cp_async_wait<1>();  // V(tile) has landed; K(tile + 1) may be in flight
    __syncthreads();
    if (active) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        // P's accumulator pairs as the A fragment: keys 8 j + 2 t and 8 j + 2 t + 1
        uint32_t a_hi[4], a_lo[4];
        split(s[j][0], a_hi[0], a_lo[0]);
        split(s[j][2], a_hi[1], a_lo[1]);
        split(s[j][1], a_hi[2], a_lo[2]);
        split(s[j][3], a_hi[3], a_lo[3]);
        const float* v0 = s_v + (8 * j + 2 * t) * LDV + g;
#pragma unroll
        for (int c = 0; c < NT_O; c += 4) {
          uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            split(v0[8 * (c + u)], b_hi[u][0], b_lo[u][0]);
            split(v0[LDV + 8 * (c + u)], b_hi[u][1], b_lo[u][1]);
          }
          mma_3xtf32_x4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }
    __syncthreads();  // every warp is done with V(tile)
    if (tile + 1 < tiles) load_tile(s_v, LDV, vb, k0 + kBK, kBK, n, hd, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + g + 8 * h;
    if (r >= n) continue;
    const float inv = 1.f / fmaxf(l_row[h], 1e-30f);
    float* orow = o + base + static_cast<size_t>(r) * hd;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < hd) orow[c] = acc[j][2 * h] * inv;
      if (c + 1 < hd) orow[c + 1] = acc[j][2 * h + 1] * inv;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int batch, int n, int hd,
           float scale, cudaStream_t stream) {
  // the large shared-memory attribute, once per process and device
  static std::once_flag once[kMaxDevices];
  static cudaError_t set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[dev], [dev] {
    set[dev] = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem_bytes<HD>()));
  });
  if (set[dev] != cudaSuccess) return static_cast<int>(set[dev]);
  const dim3 grid((n + kBQ - 1) / kBQ, batch);
  flash_attention_kernel<HD><<<grid, kThreads, smem_bytes<HD>(), stream>>>(q, k, v, o, n, hd,
                                                                          scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, n, hd) float32, contiguous, on the device. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
int skyeye_flash_attention(const float* q, const float* k, const float* v, float* o, int batch,
                           int n, int hd, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || hd <= 0) return 0;
  if (hd > kMaxHeadDim || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch<32>(q, k, v, o, batch, n, hd, scale, s);
  if (hd <= 64) return launch<64>(q, k, v, o, batch, n, hd, scale, s);
  if (hd <= 128) return launch<128>(q, k, v, o, batch, n, hd, scale, s);
  return launch<kMaxHeadDim>(q, k, v, o, batch, n, hd, scale, s);
}

}  // extern "C"
