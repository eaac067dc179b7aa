// Fused CSP block over BN-folded weights for Hopper (sm_90a) on the bf16 tensor
// cores, behind a plain C interface.
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
// Products are bf16 x bf16 summed in float32; SiLU is taken in float32.
//
// Bound: at csp1's serving shape (16, 320, 320, 64), h = 32, nb = 1, the block
// reads x once and writes the output once, 420 MB, 0.13 ms at 3.35 TB/s; its
// 63 GFLOP would take 0.06 ms on the bf16 tensor cores. So the bytes bound it.
//
// Design: one block of 8 warps per tile of tile_rows x 32 output pixels of one
// image. The block copies the tile with nb halo pixels on every side (zeros
// outside the image) into shared memory by cp.async, 16 bytes a thread where C
// % 8 == 0, and the weights, packed once by the wrapper in mma fragment order,
// beside it. Nothing but x, the weights and the output touches device memory.
// Every convolution is a GEMM with M = pixels on mma.sync.m16n8k16 bf16:
//   cv1, m1, cv2: 1x1, K = C or h, N = h;
//   the 3x3: nine shifted GEMMs over the halo grid (a tap shifts the rows);
//   cv3: K = [work, bypass], N = C_out.
// A warp takes 16 consecutive pixels of the tile's halo grid at a time (rows
// by ldmatrix.x4, one pixel a lane, so a 3x3 tap only moves the row
// addresses) and N in groups of 32 channels; the B fragments are one 8-byte
// load a lane. Each 3x3 shrinks the valid region by one pixel a side, so after
// nb bottlenecks the tile's own pixels remain; a GEMM runs over the linear
// range of grid pixels from its region's first pixel to its last, and results
// at the halo columns inside that range are finite and never read by a valid
// pixel. Channels are zero-padded in shared memory to 16 (K) and 32 (N), with
// zero weights and biases, so padded outputs are silu(0) = 0.
//
// Shared memory, per pixel of the halo grid: X (max(C, 2h, C_out) padded, + 8)
// holds x, then the bypass in channels [0, h) (written over x in place, each
// warp its own pixels) and t in [h, 2h), then the output; W (h padded + 8)
// holds the chain. Row strides of 8 mod 16 bf16 keep ldmatrix and the stores
// free of bank conflicts. Tile: 8 x 32 with nb = 1 has a 10 x 34 grid (1.33x
// the tile's pixels) in 76 KB, plus the 38 KB of packed weights: two blocks fit
// an SM, so one block's copy overlaps the other's products. 16 x 32 would cut
// the halo to 1.20x but needs 175 KB, one block an SM, and its copy would stall
// the SM; we take 8 x 32 (the wrapper's TILE_ROWS).
//
// Wider blocks: the packed weights grow as h^2 nb (skyeye_m's csp1, C 96, h 48,
// nb 2: 213 KB; skyeye_l's, C 128, h 64, nb 3: 311 KB) and the halo grid's rows
// with C, so the weights and the grid no longer fit one block's 227 KB
// together. Then (GW) the weights stay in device memory, where
// every block reads the same few hundred KB, so they are served from L2 (and
// L1), and shared memory holds the grid and the biases only: skyeye_m at 8 x 32
// takes 182 KB, skyeye_l 224 KB, one block an SM. The launcher picks the form
// that fits, shared first; ops/csp_kernel.py::smem_bytes repeats the rule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileCols = 32;  // output columns of a tile
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The padded dimensions and the packed weights' layout, shared with the
// wrapper (ops/csp_kernel.py::prepare_weights). Fragment offsets count uint2
// (4 bf16): each (k step of 16, n tile of 8) is 32 lanes x one uint2.
struct Layout {
  int cp, hp, op;  // C padded to 16, h and C_out padded to 32
  int xs, ws;      // shared-memory row strides (bf16) of X and W
  int off_cv1, off_m1, off_m2, off_cv2, off_cv3, frag_u2;
  int boff_cv1, boff_m1, boff_m2, boff_cv2, boff_cv3, bias_f;  // in floats

  __host__ __device__ Layout(int c, int h, int c_out, int nb) {
    cp = round_up(c, 16);
    hp = round_up(h, 32);
    op = round_up(c_out, 32);
    int widest = cp > 2 * hp ? cp : 2 * hp;
    widest = widest > op ? widest : op;
    xs = widest + 8;
    ws = hp + 8;
    const int kc = cp / 16, kh = hp / 16, nh = hp / 8, no = op / 8;
    off_cv1 = 0;
    off_m1 = off_cv1 + kc * nh * 32;
    off_m2 = off_m1 + nb * kh * nh * 32;
    off_cv2 = off_m2 + nb * 9 * kh * nh * 32;
    off_cv3 = off_cv2 + kc * nh * 32;
    frag_u2 = off_cv3 + 2 * kh * no * 32;
    boff_cv1 = 0;
    boff_m1 = hp;
    boff_m2 = boff_m1 + nb * hp;
    boff_cv2 = boff_m2 + nb * hp;
    boff_cv3 = boff_cv2 + hp;
    bias_f = boff_cv3 + op;  // a multiple of 32
  }
  // bytes of shared memory, with the packed weights in it or (weights_global) not
  __host__ __device__ size_t smem(int grid_pixels, bool weights_global) const {
    return (weights_global ? 0 : static_cast<size_t>(frag_u2) * 8) +
           static_cast<size_t>(bias_f) * 4 + static_cast<size_t>(grid_pixels) * (xs + ws) * 2;
  }
};

struct Params {
  const bf16* x;
  const uint2* frags;
  const float* bias;
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
  // linear range of the region a pixels in from every side of the grid
  __device__ int begin(int a) const { return a * rw + a; }
  __device__ int end(int a) const { return (rh - a) * rw - a; }
};

// SiLU in float32, v / (1 + e^-v), with the fast exp and divide: a few ulp of
// float32, far below the bf16 rounding that follows, for every v (below -87,
// where the divisor passes 2^126, the quotient is 0, within 2e-36 of SiLU)
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// register-only: not volatile, so the compiler may schedule around it
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// For the grid pixels p in [begin, end) and the output channels [0, 32 NG):
// epi(p, col, silu(bias[col] + sum), silu(bias[col + 1] + sum')) with the sum
// over TAPS taps (1: a 1x1; 9: a 3x3, tap (dy, dx) reading pixel p + (dy - 1)
// rw + dx - 1) and k steps of 16 channels: the first ks_a from A (row stride
// lda), the rest from B (stride ldb). wf holds the fragments in [tap][k step]
// [n tile][lane] order, in shared memory or (GW) in device memory. A warp holds
// every output channel of its 16 pixels before it stores any, so a conv may
// write over its own input pixels.
template <int TAPS, int NG, bool GW, typename Epi>
__device__ __forceinline__ void conv(const bf16* A, int lda, int ks_a, const bf16* B, int ldb,
                                     int ks_b, const uint2* wf, const float* bias, int rw,
                                     int begin, int end, Epi epi) {
  constexpr int NT = 4 * NG;  // n tiles of 8
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ks = ks_a + ks_b;
  const int chunks = (end - begin + 15) / 16;
  for (int chunk = warp; chunk < chunks; chunk += kWarps) {
    const int pb = begin + chunk * 16;
    // this lane's ldmatrix row: pixel (lane & 15) of the chunk, k half lane >> 4;
    // a ragged chunk repeats its last pixel
    const int prow = min(pb + (lane & 15), end - 1);
    const int khalf = 8 * (lane >> 4);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int p = TAPS == 1 ? prow : prow + (tap / 3 - 1) * rw + (tap % 3 - 1);
      const uint2* w = wf + tap * ks * NT * 32 + lane;
#pragma unroll 2
      for (int s = 0; s < ks; ++s, w += NT * 32) {
        uint32_t a[4];
        ldmatrix_x4(a, s < ks_a ? A + p * lda + 16 * s + khalf
                                : B + p * ldb + 16 * (s - ks_a) + khalf);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, GW ? __ldg(w + 32 * j) : w[32 * j]);
      }
    }
    const int p0 = pb + g, p1 = p0 + 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
      if (p0 < end) epi(p0, col, silu(acc[j][0] + b0), silu(acc[j][1] + b1));
      if (p1 < end) epi(p1, col, silu(acc[j][2] + b0), silu(acc[j][3] + b1));
    }
  }
}

// NGH = h padded / 32 and NGO = C_out padded / 32: the output groups of the
// convs into the chain and of cv3; GW: the weights are read from device memory.
template <int NGH, int NGO, bool GW>
__global__ void __launch_bounds__(kThreads, 2) csp_fused_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = prm.nb, c = prm.c, c_out = prm.c_out;
  const Layout L(c, prm.h, c_out, nb);
  Grid grid;
  grid.rh = prm.tile_rows + 2 * nb;
  grid.rw = kTileCols + 2 * nb;
  grid.y0 = blockIdx.y * prm.tile_rows - nb;
  grid.x0 = blockIdx.x * kTileCols - nb;
  grid.height = prm.height;
  grid.width = prm.width;
  const int rw = grid.rw, npix = grid.rh * rw;
  uint2* s_frag = reinterpret_cast<uint2*>(smem_raw);
  float* s_bias = reinterpret_cast<float*>(GW ? s_frag : s_frag + L.frag_u2);
  const uint2* wf = GW ? prm.frags : s_frag;
  bf16* X = reinterpret_cast<bf16*>(s_bias + L.bias_f);  // (npix, xs)
  bf16* W = X + npix * L.xs;                             // (npix, ws): the chain
  bf16* T = X + L.hp;                                    // t in X's channels [hp, 2 hp)
  const int xs = L.xs, ws = L.ws, hp = L.hp;
  const bf16* xb = prm.x + static_cast<size_t>(blockIdx.z) * prm.height * prm.width * c;

  // weights, biases and the tile with its halo (zeros outside the image)
  {
    const char* fsrc = reinterpret_cast<const char*>(prm.frags);
    for (int e = threadIdx.x; e < (GW ? 0 : L.frag_u2 / 2); e += kThreads)
      cp_async16(reinterpret_cast<char*>(s_frag) + 16 * e, fsrc + 16 * e, true);
    const char* bsrc = reinterpret_cast<const char*>(prm.bias);
    for (int e = threadIdx.x; e < L.bias_f / 4; e += kThreads)
      cp_async16(reinterpret_cast<char*>(s_bias) + 16 * e, bsrc + 16 * e, true);
    const bool vec8 = c % 8 == 0 && reinterpret_cast<uintptr_t>(prm.x) % 16 == 0;
    const int step = vec8 ? 8 : 2, per_pix = c / step;
    for (int e = threadIdx.x; e < npix * per_pix; e += kThreads) {
      const int p = e / per_pix, ch = (e - p * per_pix) * step;
      const bool in = grid.inside(p);
      const bf16* src =
          in ? xb + (static_cast<size_t>(grid.y0 + p / rw) * prm.width + grid.x0 + p % rw) * c +
                   ch
             : xb;
      if (vec8) {
        cp_async16(X + p * xs + ch, src, in);
      } else {
        cp_async4(X + p * xs + ch, src, in);
      }
    }
    // channels c..cp of x are read by the products: zero them (never copied)
    const int pad = L.cp - c;
    for (int e = threadIdx.x; e < npix * pad; e += kThreads)
      X[(e / pad) * xs + c + e % pad] = __float2bfloat16(0.f);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 0;\n");
  }
  __syncthreads();

  const int kc = L.cp / 16, kh = hp / 16, nh = hp / 8;
  // cv1 over the whole grid
  conv<1, NGH, GW>(X, xs, kc, nullptr, 0, 0, wf + L.off_cv1, s_bias + L.boff_cv1, rw, 0, npix,
          [&](int p, int col, float v0, float v1) {
            *reinterpret_cast<uint32_t*>(W + p * ws + col) = pack2(v0, v1);
          });
  __syncthreads();
  // cv2 (the bypass) over the tile's own region, written over x in place: a
  // warp reads all of its pixels' channels before it stores any
  conv<1, NGH, GW>(X, xs, kc, nullptr, 0, 0, wf + L.off_cv2, s_bias + L.boff_cv2, rw,
               grid.begin(nb), grid.end(nb), [&](int p, int col, float v0, float v1) {
            *reinterpret_cast<uint32_t*>(X + p * xs + col) = pack2(v0, v1);
          });
  __syncthreads();

  for (int i = 0; i < nb; ++i) {
    // t over the region still valid; the 3x3 reads zeros outside the image
    conv<1, NGH, GW>(W, ws, kh, nullptr, 0, 0, wf + L.off_m1 + i * kh * nh * 32,
                 s_bias + L.boff_m1 + i * hp, rw, grid.begin(i), grid.end(i),
            [&](int p, int col, float v0, float v1) {
              const bool in = grid.inside(p);
              *reinterpret_cast<uint32_t*>(T + p * xs + col) =
                  pack2(in ? v0 : 0.f, in ? v1 : 0.f);
            });
    __syncthreads();
    // the 3x3 and the bf16 residual: each lane updates only the pair it reads
    conv<9, NGH, GW>(T, xs, kh, nullptr, 0, 0, wf + L.off_m2 + i * 9 * kh * nh * 32,
                 s_bias + L.boff_m2 + i * hp, rw, grid.begin(i + 1), grid.end(i + 1),
            [&](int p, int col, float v0, float v1) {
              uint32_t* w = reinterpret_cast<uint32_t*>(W + p * ws + col);
              const float2 old = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(w));
              const float r0 = __bfloat162float(__float2bfloat16(v0));
              const float r1 = __bfloat162float(__float2bfloat16(v1));
              *w = pack2(old.x + r0, old.y + r1);
            });
    __syncthreads();
  }

  // cv3 over [chain, bypass], written over the bypass in place (as cv2)
  conv<1, NGO, GW>(W, ws, kh, X, xs, kh, wf + L.off_cv3, s_bias + L.boff_cv3, rw,
               grid.begin(nb), grid.end(nb), [&](int p, int col, float v0, float v1) {
            *reinterpret_cast<uint32_t*>(X + p * xs + col) = pack2(v0, v1);
          });
  __syncthreads();

  // the tile's own pixels inside the image to device memory
  bf16* ob = prm.out + static_cast<size_t>(blockIdx.z) * prm.height * prm.width * c_out;
  const bool vec8 = c_out % 8 == 0 && reinterpret_cast<uintptr_t>(prm.out) % 16 == 0;
  const int step = vec8 ? 8 : 2, per_pix = c_out / step;
  const int rows = prm.tile_rows;
  for (int e = threadIdx.x; e < rows * kTileCols * per_pix; e += kThreads) {
    const int q = e / per_pix, ch = (e - q * per_pix) * step;
    const int ly = nb + q / kTileCols, lx = nb + q % kTileCols;
    const int gy = grid.y0 + ly, gx = grid.x0 + lx;
    if (gy >= prm.height || gx >= prm.width) continue;
    const bf16* src = X + (ly * rw + lx) * xs + ch;
    bf16* dst = ob + (static_cast<size_t>(gy) * prm.width + gx) * c_out + ch;
    if (vec8) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
    }
  }
}

template <int NGH, int NGO, bool GW>
int launch(const Params& prm, dim3 grid, size_t smem, cudaStream_t stream) {
  // the shared-memory attribute, at the most a block may use, once per process and device
  static std::once_flag once[kMaxDevices];
  static cudaError_t set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[dev], [dev] {
    set[dev] = cudaFuncSetAttribute(csp_fused_kernel<NGH, NGO, GW>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (set[dev] != cudaSuccess) return static_cast<int>(set[dev]);
  csp_fused_kernel<NGH, NGO, GW><<<grid, kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (batch, height, width, c) bf16 and out (batch, height, width, c_out) bf16,
// contiguous; frags: the weights packed by ops/csp_kernel.py::prepare_weights in
// mma fragment order (Layout::frag_u2 uint2, 16-byte aligned); bias: the padded
// biases (Layout::bias_f float32, 16-byte aligned). c, h and c_out even, x and
// out 4-byte aligned. Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
int skyeye_csp_fused(const void* x, const void* frags, const float* bias, void* out, int batch,
                     int height, int width, int c, int h, int c_out, int nb, int tile_rows,
                     void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (c <= 0 || h <= 0 || c_out <= 0 || nb <= 0 || tile_rows <= 0 || c % 2 || h % 2 ||
      c_out % 2 || batch > 65535 || reinterpret_cast<uintptr_t>(x) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 4 || reinterpret_cast<uintptr_t>(frags) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(c, h, c_out, nb);
  const int pixels = (tile_rows + 2 * nb) * (kTileCols + 2 * nb);
  const bool gw = L.smem(pixels, false) > static_cast<size_t>(kMaxSmem);
  const size_t smem = L.smem(pixels, gw);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  Params prm{static_cast<const bf16*>(x), static_cast<const uint2*>(frags), bias,
             static_cast<bf16*>(out), height, width, c, h, c_out, nb, tile_rows};
  const dim3 grid((width + kTileCols - 1) / kTileCols, (height + tile_rows - 1) / tile_rows,
                  batch);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ngh = L.hp / 32, ngo = L.op / 32;
#define SKYEYE_CSP_GROUP(NGH, NGO)                                                  \
  if (ngh == NGH && ngo == NGO)                                                     \
    return gw ? launch<NGH, NGO, true>(prm, grid, smem, s)                          \
              : launch<NGH, NGO, false>(prm, grid, smem, s);
  SKYEYE_CSP_GROUP(1, 1)
  SKYEYE_CSP_GROUP(1, 2)
  SKYEYE_CSP_GROUP(1, 4)
  SKYEYE_CSP_GROUP(2, 2)
  SKYEYE_CSP_GROUP(2, 3)
  SKYEYE_CSP_GROUP(2, 4)
#undef SKYEYE_CSP_GROUP
  return static_cast<int>(cudaErrorInvalidValue);  // see SUPPORTED_GROUPS in ops/csp_kernel.py
}

}  // extern "C"
