// Fused CSP block over BN-folded weights for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the Pallas TPU kernels in skyeye_tpu/ops/pallas/csp_kernel.py:
//   skyeye_csp_fused  <- csp_fused_v2 / _csp_kernel_dma (K3)
//                     <- csp_fused / _csp_kernel (K3b)
// The two TPU versions compute one function and differ only in how the TPU
// stages memory (a resident image against a per-tile halo DMA), so one kernel
// serves both.
//
// Function, in the TPU kernel's rounding: x (B, H, W, C) bf16 NHWC;
//   work = bf16(silu(x . w_cv1 + b_cv1))                       1x1 C->h
//   nb times: t = bf16(silu(work . w_m1 + b_m1)), zero outside the image
//             work = bf16(work + bf16(silu(b_m2 + conv3x3(t, w_m2))))
//   bypass = bf16(silu(x . w_cv2 + b_cv2))                     1x1 C->h
//   out = bf16(silu([work, bypass] . w_cv3 + b_cv3))           1x1 2h->C_out
// Products are summed in float32; SiLU is taken in float32. Weights arrive as
// float32 holding bf16 values.
//
// Design: one block per tile of tile_rows x 32 output pixels of one image. The
// block loads the tile with nb halo pixels on every side (zeros outside the
// image) into shared memory, and keeps there the chain (work) and the 3x3's input
// (t), both bf16, over the same halo grid: nothing but x and the output touches
// device memory. Each 3x3 shrinks the valid region by one pixel a side, so after
// nb bottlenecks the tile's own pixels remain. The TPU kernel tiles rows only
// and pads W in VMEM; a row of 320 x 64 bf16 is 40 KB here, so the tile is cut
// in W too, and the 3x3's W edges are the masked halo.
//
// Each thread computes 4 pixels of one output channel: a weight (float32, read
// through the read-only cache, coalesced across the warp's channels) is used 4
// times, and activations are read as bf16 pairs that the warp's lanes share.
//
// Bound: at csp1's serving shape (16, 320, 320, 64), h = 32, nb = 1, the block
// reads x once and writes the output once, 420 MB, 0.13 ms at 3.35 TB/s; its
// 63 GFLOP would take 0.06 ms on the bf16 tensor cores. So the bytes bound it.
// This simple kernel runs its products on the CUDA cores' float32 FMAs, which
// bound it instead; tensor cores (mma or wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTileCols = 32;  // output columns of a tile
constexpr int kPix = 4;        // pixels per thread and output channel

struct Params {
  const bf16* x;
  const float *w_cv1, *b_cv1, *w_m1, *b_m1, *w_m2, *b_m2, *w_cv2, *b_cv2, *w_cv3, *b_cv3;
  bf16* out;
  int height, width, c, h, c_out, nb, tile_rows;
};

// The tile's halo grid: local (ly, lx) is image pixel (y0 + ly, x0 + lx).
struct Grid {
  int rh, rw, y0, x0, height, width;
  __device__ bool inside(int p) const {
    const int gy = y0 + p / rw, gx = x0 + p % rw;
    return gy >= 0 && gy < height && gx >= 0 && gx < width;
  }
};

__device__ __forceinline__ float silu(float v) { return v * (1.f / (1.f + expf(-v))); }

// acc[j] += sum_c in[pix[j] + shift, c] * w[c, o] over channel pairs.
__device__ __forceinline__ void accumulate(const bf16* in, int ld, int cin, const float* w,
                                           int cout, int o, const int* pix, int shift,
                                           float* acc) {
  for (int c = 0; c < cin; c += 2) {
    const float w0 = __ldg(w + c * cout + o), w1 = __ldg(w + (c + 1) * cout + o);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(in + (pix[j] + shift) * ld + c));
      acc[j] = fmaf(f.x, w0, acc[j]);
      acc[j] = fmaf(f.y, w1, acc[j]);
    }
  }
}

// For the pixels p of the local rectangle [r0, r1) x [c0, c1) and each output
// channel o: store(p, o, silu(bias[o] + sum over taps and channels)). The input
// is a (cin_a channels) then b (cin_b channels), read at p shifted by each tap;
// TAPS is 1 (a 1x1) or 9 (a 3x3, tap-major weights (3, 3, cin, cout)).
template <int TAPS, typename Store>
__device__ void conv(const bf16* a, int lda, int cin_a, const bf16* b, int ldb, int cin_b,
                     const float* w, const float* bias, int cout, int rw, int r0, int r1,
                     int c0, int c1, Store store) {
  const int wd = c1 - c0, npix = (r1 - r0) * wd;
  const int items = (npix + kPix - 1) / kPix * cout;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int o = item % cout, g = item / cout;
    int pix[kPix];
    float acc[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int q = min(g * kPix + j, npix - 1);  // a ragged group repeats its last pixel
      pix[j] = (r0 + q / wd) * rw + c0 + q % wd;
      acc[j] = 0.f;
    }
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int shift = TAPS == 1 ? 0 : (tap / 3 - 1) * rw + (tap % 3 - 1);
      const float* wt = w + tap * (cin_a + cin_b) * cout;
      accumulate(a, lda, cin_a, wt, cout, o, pix, shift, acc);
      if (cin_b) accumulate(b, ldb, cin_b, wt + cin_a * cout, cout, o, pix, shift, acc);
    }
    const float bo = __ldg(bias + o);
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (g * kPix + j < npix) store(pix[j], o, silu(acc[j] + bo));
  }
}

__global__ void __launch_bounds__(kThreads) csp_fused_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = prm.nb, c = prm.c, h = prm.h;
  Grid grid;
  grid.rh = prm.tile_rows + 2 * nb;
  grid.rw = kTileCols + 2 * nb;
  grid.y0 = blockIdx.y * prm.tile_rows - nb;
  grid.x0 = blockIdx.x * kTileCols - nb;
  grid.height = prm.height;
  grid.width = prm.width;
  const int rh = grid.rh, rw = grid.rw, npix = rh * rw;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // (npix, C) input tile
  bf16* work = xs + npix * c;                      // (npix, h) the chain
  bf16* t = work + npix * h;                       // (npix, h) 3x3 input, then the bypass
  const bf16* xb = prm.x + static_cast<size_t>(blockIdx.z) * prm.height * prm.width * c;

  // the tile and its halo; zeros outside the image
  const bool vec8 = c % 8 == 0 && reinterpret_cast<uintptr_t>(prm.x) % 16 == 0;
  const int step = vec8 ? 8 : 2;
  const int per_pix = c / step;
  for (int e = threadIdx.x; e < npix * per_pix; e += kThreads) {
    const int p = e / per_pix, ch = (e - p * per_pix) * step;
    const bool in = grid.inside(p);
    const bf16* src =
        in ? xb + (static_cast<size_t>(grid.y0 + p / rw) * prm.width + grid.x0 + p % rw) * c + ch
           : nullptr;
    if (vec8) {
      *reinterpret_cast<uint4*>(xs + p * c + ch) =
          in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    } else {
      *reinterpret_cast<uint32_t*>(xs + p * c + ch) =
          in ? *reinterpret_cast<const uint32_t*>(src) : 0u;
    }
  }
  __syncthreads();

  auto to_work = [&](int p, int o, float v) { work[p * h + o] = __float2bfloat16(v); };
  conv<1>(xs, c, c, nullptr, 0, 0, prm.w_cv1, prm.b_cv1, h, rw, 0, rh, 0, rw, to_work);
  __syncthreads();

  for (int i = 0; i < nb; ++i) {
    // t over the region still valid; the 3x3 reads zeros outside the image
    auto to_t = [&](int p, int o, float v) {
      t[p * h + o] = __float2bfloat16(grid.inside(p) ? v : 0.f);
    };
    conv<1>(work, h, h, nullptr, 0, 0, prm.w_m1 + i * h * h, prm.b_m1 + i * h, h, rw, i,
            rh - i, i, rw - i, to_t);
    __syncthreads();
    // residual in bf16: each thread updates only the (pixel, channel) it reads
    auto residual = [&](int p, int o, float v) {
      const float sum = __bfloat162float(work[p * h + o]) +
                        __bfloat162float(__float2bfloat16(v));
      work[p * h + o] = __float2bfloat16(sum);
    };
    conv<9>(t, h, h, nullptr, 0, 0, prm.w_m2 + i * 9 * h * h, prm.b_m2 + i * h, h, rw, i + 1,
            rh - i - 1, i + 1, rw - i - 1, residual);
    __syncthreads();
  }

  // bypass on the tile's own pixels, into t (free now)
  auto to_bypass = [&](int p, int o, float v) { t[p * h + o] = __float2bfloat16(v); };
  conv<1>(xs, c, c, nullptr, 0, 0, prm.w_cv2, prm.b_cv2, h, rw, nb, rh - nb, nb, rw - nb,
          to_bypass);
  __syncthreads();

  bf16* ob = prm.out + static_cast<size_t>(blockIdx.z) * prm.height * prm.width * prm.c_out;
  const int c_out = prm.c_out;
  auto to_out = [&](int p, int o, float v) {
    if (!grid.inside(p)) return;  // the ragged edge of the image
    const int gy = grid.y0 + p / rw, gx = grid.x0 + p % rw;
    ob[(static_cast<size_t>(gy) * prm.width + gx) * c_out + o] = __float2bfloat16(v);
  };
  conv<1>(work, h, h, t, h, h, prm.w_cv3, prm.b_cv3, c_out, rw, nb, rh - nb, nb, rw - nb,
          to_out);
}

}  // namespace

extern "C" {

// x (batch, height, width, c) bf16 and out (batch, height, width, c_out) bf16,
// contiguous; weights float32 in the JAX layout: w_cv1 (c, h), b_cv1 (h),
// w_m1 (nb, h, h), b_m1 (nb, h), w_m2 (nb, 3, 3, h, h), b_m2 (nb, h), w_cv2 (c, h),
// b_cv2 (h), w_cv3 (2h, c_out), b_cv3 (c_out). c and h even, x 4-byte aligned. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
int skyeye_csp_fused(const void* x, const float* w_cv1, const float* b_cv1, const float* w_m1,
                     const float* b_m1, const float* w_m2, const float* b_m2,
                     const float* w_cv2, const float* b_cv2, const float* w_cv3,
                     const float* b_cv3, void* out, int batch, int height, int width, int c,
                     int h, int c_out, int nb, int tile_rows, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (c <= 0 || h <= 0 || c_out <= 0 || nb <= 0 || tile_rows <= 0 || c % 2 || h % 2 ||
      batch > 65535 || reinterpret_cast<uintptr_t>(x) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{static_cast<const bf16*>(x), w_cv1, b_cv1, w_m1, b_m1, w_m2, b_m2, w_cv2, b_cv2,
             w_cv3, b_cv3, static_cast<bf16*>(out), height, width, c, h, c_out, nb, tile_rows};
  const size_t smem = static_cast<size_t>(tile_rows + 2 * nb) * (kTileCols + 2 * nb) *
                      (c + 2 * h) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      csp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + kTileCols - 1) / kTileCols, (height + tile_rows - 1) / tile_rows,
                  batch);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  csp_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
