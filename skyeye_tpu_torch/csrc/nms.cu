// Greedy class-offset NMS for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernels in skyeye_tpu/ops/pallas/nms_kernel.py:
//   skyeye_batched_greedy_nms  <- pallas_batched_greedy_nms / _nms_batched_kernel (K1)
//   skyeye_greedy_nms          <- pallas_greedy_nms / _nms_kernel (K2)
// Both run the same kernels: one thread block per image.
//
// Semantics (identical to skyeye_tpu/ops/nms.py::_greedy_nms): each step takes
// the live candidate with the highest score (ties to the lowest index); the step
// is valid when that score is > 0. A valid winner is written to keep_idx /
// keep_valid, and every live candidate whose IoU with it is > iou_thres dies,
// the winner too. The loop ends after max_det steps or at the first invalid
// step, so it always ends. Unused output slots hold index 0 and valid 0.
//
// Bound: the work is O(steps * k) compare/IoU operations, a few microseconds of
// the card's float32 rate, but each step depends on the one before, so the
// kernel is bound by the latency of one step: a block-wide argmax and two
// barriers. The design keeps every candidate in registers (ITEMS per thread, a
// strided slice so loads coalesce), reduces with warp shuffles and one pass
// over the per-warp winners, and touches global memory only for the winner's
// box and the outputs. That holds k <= kThreads * kMaxItems = 4096.
//
// Above 4096 candidates a second kernel runs the same loop with the live scores
// in device memory: a (B, k) float32 scratch that the wrapper allocates. Each
// thread owns the same strided slice of candidates as in the register path,
// reads its boxes from device memory (L2 holds an image's 20 bytes a candidate)
// and recomputes each area with the same expression, so the keep-set, its
// order, the tie rule and the loop bound are the register path's. It is not
// tuned: only inputs above 4096 candidates take it.
//
// Bit-exact IoU: build with -fmad=false and without --use_fast_math, so each
// operation rounds as PyTorch's separate elementwise ops do; the order of
// operations is the JAX formula's: inter / (area + barea - inter + 1e-7).
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 16;  // kThreads * kMaxItems = 4096 candidates per image

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// What the block shares in each step: the per-warp candidates and the winner.
struct StepShared {
  float score[kWarps];
  int idx[kWarps];
  float win[6];  // score, x1, y1, x2, y2, area of the step's winner
  int best;
};

// Block argmax on (score, -index) from each thread's (bs, bi); the winner's box
// goes to sh.win and, if its score is > 0, to the outputs. Ends with a barrier,
// after which every thread reads the same sh.win[0] and sh.best.
__device__ __forceinline__ void block_winner(float bs, int bi, const float* bx, int step,
                                             int32_t* out_idx, uint8_t* out_valid,
                                             StepShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(os, oi, bs, bi)) {
      bs = os;
      bi = oi;
    }
  }
  if (lane == 0) {
    sh.score[warp] = bs;
    sh.idx[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bs = lane < kWarps ? sh.score[lane] : -INFINITY;
    bi = lane < kWarps ? sh.idx[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      sh.win[0] = bs;
      sh.best = bi;
      if (bs > 0.f) {
        const float wx1 = bx[4 * bi + 0], wy1 = bx[4 * bi + 1];
        const float wx2 = bx[4 * bi + 2], wy2 = bx[4 * bi + 3];
        sh.win[1] = wx1;
        sh.win[2] = wy1;
        sh.win[3] = wx2;
        sh.win[4] = wy2;
        sh.win[5] = fmaxf(wx2 - wx1, 0.f) * fmaxf(wy2 - wy1, 0.f);
        out_idx[step] = bi;
        out_valid[step] = 1;
      }
    }
  }
  __syncthreads();
}

// True when candidate (x1, y1, x2, y2, area) overlaps the winner by more than
// iou_thres, in the JAX formula's order of operations.
__device__ __forceinline__ bool suppressed(float x1, float y1, float x2, float y2, float area,
                                           const float* win, float iou_thres) {
  const float iw = fmaxf(fminf(x2, win[3]) - fmaxf(x1, win[1]), 0.f);
  const float ih = fmaxf(fminf(y2, win[4]) - fmaxf(y1, win[2]), 0.f);
  const float inter = iw * ih;
  const float iou = inter / (area + win[5] - inter + 1e-7f);
  return iou > iou_thres;
}

__device__ __forceinline__ void zero_outputs(int max_det, int32_t* out_idx,
                                             uint8_t* out_valid) {
  for (int i = threadIdx.x; i < max_det; i += kThreads) {
    out_idx[i] = 0;
    out_valid[i] = 0;
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float* __restrict__ boxes,    // (B, k, 4) xyxy, class-offset
                  const float* __restrict__ scores,   // (B, k), invalid < 0
                  int k, int max_det, float iou_thres,
                  int32_t* __restrict__ keep_idx,     // (B, max_det)
                  uint8_t* __restrict__ keep_valid) { // (B, max_det), bool
  const int tid = threadIdx.x;
  const float* bx = boxes + static_cast<size_t>(blockIdx.x) * k * 4;
  const float* sc = scores + static_cast<size_t>(blockIdx.x) * k;
  int32_t* out_idx = keep_idx + static_cast<size_t>(blockIdx.x) * max_det;
  uint8_t* out_valid = keep_valid + static_cast<size_t>(blockIdx.x) * max_det;
  __shared__ StepShared sh;

  zero_outputs(max_det, out_idx, out_valid);
  float x1[ITEMS], y1[ITEMS], x2[ITEMS], y2[ITEMS], area[ITEMS], live[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * kThreads + tid;
    if (i < k) {
      x1[j] = bx[4 * i + 0];
      y1[j] = bx[4 * i + 1];
      x2[j] = bx[4 * i + 2];
      y2[j] = bx[4 * i + 3];
      area[j] = fmaxf(x2[j] - x1[j], 0.f) * fmaxf(y2[j] - y1[j], 0.f);
      live[j] = sc[i];
    } else {
      x1[j] = y1[j] = x2[j] = y2[j] = area[j] = 0.f;
      live[j] = -1.f;
    }
  }
  __syncthreads();  // the zeroed outputs are visible before thread 0 writes winners

  for (int step = 0; step < max_det; ++step) {
    float bs = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = j * kThreads + tid;
      if (i < k && better(live[j], i, bs, bi)) {
        bs = live[j];
        bi = i;
      }
    }
    block_winner(bs, bi, bx, step, out_idx, out_valid, sh);
    if (!(sh.win[0] > 0.f)) break;  // the same value in every thread: no live candidate

    const int best = sh.best;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = j * kThreads + tid;
      if (suppressed(x1[j], y1[j], x2[j], y2[j], area[j], sh.win, iou_thres) || i == best)
        live[j] = -1.f;
    }
  }
}

// The same loop for any k, with the live scores in device memory (live_all,
// (B, k)); each thread reads and writes only its own candidates.
__global__ void __launch_bounds__(kThreads)
greedy_nms_global_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                         int k, int max_det, float iou_thres, float* __restrict__ live_all,
                         int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_valid) {
  const int tid = threadIdx.x;
  const float* bx = boxes + static_cast<size_t>(blockIdx.x) * k * 4;
  const float* sc = scores + static_cast<size_t>(blockIdx.x) * k;
  float* live = live_all + static_cast<size_t>(blockIdx.x) * k;
  int32_t* out_idx = keep_idx + static_cast<size_t>(blockIdx.x) * max_det;
  uint8_t* out_valid = keep_valid + static_cast<size_t>(blockIdx.x) * max_det;
  __shared__ StepShared sh;

  zero_outputs(max_det, out_idx, out_valid);
  for (int i = tid; i < k; i += kThreads) live[i] = sc[i];
  __syncthreads();

  for (int step = 0; step < max_det; ++step) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < k; i += kThreads) {
      const float s = live[i];
      if (better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
    block_winner(bs, bi, bx, step, out_idx, out_valid, sh);
    if (!(sh.win[0] > 0.f)) break;

    const int best = sh.best;
    for (int i = tid; i < k; i += kThreads) {
      const float4 b = reinterpret_cast<const float4*>(bx)[i];
      const float area = fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
      if (suppressed(b.x, b.y, b.z, b.w, area, sh.win, iou_thres) || i == best) live[i] = -1.f;
    }
  }
}

template <int ITEMS>
cudaError_t launch(const float* boxes, const float* scores, int batch, int k, int max_det,
                   float iou_thres, int32_t* keep_idx, uint8_t* keep_valid,
                   cudaStream_t stream) {
  greedy_nms_kernel<ITEMS><<<batch, kThreads, 0, stream>>>(
      boxes, scores, k, max_det, iou_thres, keep_idx, keep_valid);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* boxes, const float* scores, int batch, int k, int max_det,
                     float iou_thres, float* scratch, int32_t* keep_idx, uint8_t* keep_valid,
                     void* stream) {
  if (batch <= 0 || k <= 0 || max_det <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kThreads * kMaxItems) {
    if (scratch == nullptr || reinterpret_cast<uintptr_t>(boxes) % 16) return cudaErrorInvalidValue;
    greedy_nms_global_kernel<<<batch, kThreads, 0, s>>>(boxes, scores, k, max_det, iou_thres,
                                                         scratch, keep_idx, keep_valid);
    return cudaGetLastError();
  }
  const int items = (k + kThreads - 1) / kThreads;
  if (items <= 1) return launch<1>(boxes, scores, batch, k, max_det, iou_thres, keep_idx, keep_valid, s);
  if (items <= 2) return launch<2>(boxes, scores, batch, k, max_det, iou_thres, keep_idx, keep_valid, s);
  if (items <= 4) return launch<4>(boxes, scores, batch, k, max_det, iou_thres, keep_idx, keep_valid, s);
  if (items <= 8) return launch<8>(boxes, scores, batch, k, max_det, iou_thres, keep_idx, keep_valid, s);
  return launch<16>(boxes, scores, batch, k, max_det, iou_thres, keep_idx, keep_valid, s);
}

}  // namespace

extern "C" {

// K1: greedy NMS over a batch, one block per image. scratch: (batch, k) float32
// when k > 4096, else unused (may be null). Returns a cudaError_t.
int skyeye_batched_greedy_nms(const float* boxes, const float* scores, int batch, int k,
                              int max_det, float iou_thres, float* scratch, int32_t* keep_idx,
                              uint8_t* keep_valid, void* stream) {
  return static_cast<int>(dispatch(boxes, scores, batch, k, max_det, iou_thres, scratch,
                                   keep_idx, keep_valid, stream));
}

// K2: greedy NMS for one image; scratch as for K1. Returns a cudaError_t.
int skyeye_greedy_nms(const float* boxes, const float* scores, int k, int max_det,
                      float iou_thres, float* scratch, int32_t* keep_idx, uint8_t* keep_valid,
                      void* stream) {
  return static_cast<int>(dispatch(boxes, scores, 1, k, max_det, iou_thres, scratch, keep_idx,
                                   keep_valid, stream));
}

}  // extern "C"
