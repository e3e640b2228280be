// Multi-scale deformable attention, one call for every head, level and
// point of a decoder layer (RT-DETR's cross-attention).
//
// For query q of frame b and head h, with L value maps of (H_l, W_l)
// positions flattened one after another into S rows of H heads x D channels:
//
//   a[l, p]   = softmax over the L * P logits of (b, q, h)
//   loc[l, p] = ref_xy + off[l, p] / P * ref_wh * 0.5
//   out[c]    = sum over l, p of a[l, p] * bilinear(v_l[., h, c], loc[l, p])
//
// bilinear is F.grid_sample's: grid = 2 * loc - 1, align_corners=False,
// zero padding (a corner outside the map adds nothing and is not read).
// The softmax, the locations and the sums are float32; the value and the
// output are float32, bfloat16 or float16. ops/msda.py::msda_plain is the
// plain PyTorch form the kernel is held to.
//
// Bound: bytes. Each corner reads one (head, channel) element per thread;
// the D threads of a head read one contiguous row of D elements, so a
// corner is D * sizeof(T) bytes (two 32-byte sectors at D = 32 in
// bfloat16). Least traffic: the distinct sectors of the value that in-map
// corners touch, the offsets, logits and boxes read once, the output
// written once (portbench/arith/msda_bytes.py counts it).
//
// Design: one block per (frame, query), one thread per (head, channel).
// Each thread computes its head's softmax and locations itself (the reads
// of a head's logits and offsets are the same address across its threads,
// so they are broadcast), then gathers its channel at every corner. The
// grid depends on B and Q only, and nothing is read on the host, so the
// call can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxLevelPoints = 32;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <typename T>
__device__ __forceinline__ float load(const T* p) {
  return static_cast<float>(*p);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <>
__device__ __forceinline__ float load<__half>(const __half* p) {
  return __half2float(*p);
}

template <typename T>
__device__ __forceinline__ T store(float v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half store<__half>(float v) {
  return __float2half(v);
}

template <typename T>
__global__ void msda_kernel(const T* __restrict__ value, const float* __restrict__ offsets,
                            const float* __restrict__ logits, const float* __restrict__ ref,
                            T* __restrict__ out, Levels lv, int S, int Q, int H, int D, int L,
                            int P) {
  const int bq = blockIdx.x;
  const int h = threadIdx.x / D;
  const int c = threadIdx.x - h * D;
  if (h >= H) return;
  const int b = bq / Q;
  const int lp = L * P;
  const long long head = static_cast<long long>(bq) * H + h;

  float a[kMaxLevelPoints];
  const float* lg = logits + head * lp;
  float top = -INFINITY;
  for (int i = 0; i < lp; ++i) {
    a[i] = lg[i];
    top = fmaxf(top, a[i]);
  }
  float sum = 0.f;
  for (int i = 0; i < lp; ++i) {
    a[i] = expf(a[i] - top);
    sum += a[i];
  }

  const float* box = ref + static_cast<long long>(bq) * 4;
  const float cx = box[0], cy = box[1], bw = box[2], bh = box[3];
  const float* off = offsets + head * lp * 2;
  const long long row = static_cast<long long>(H) * D;
  const T* vb = value + static_cast<long long>(b) * S * row + static_cast<long long>(h) * D + c;
  const float fp = static_cast<float>(P);

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const T* v = vb + static_cast<long long>(lv.start[l]) * row;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float lx = cx + off[2 * i] / fp * bw * 0.5f;
      const float ly = cy + off[2 * i + 1] / fp * bh * 0.5f;
      // grid_sample's unnormalization of grid = 2 * loc - 1
      const float x = ((2.f * lx - 1.f + 1.f) * wl - 1.f) / 2.f;
      const float y = ((2.f * ly - 1.f + 1.f) * hl - 1.f) / 2.f;
      const float x0f = floorf(x), y0f = floorf(y);
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
      const float fx = x - x0f, fy = y - y0f;
      const float gx = x0f + 1.f - x, gy = y0f + 1.f - y;
      float s = 0.f;
      const bool in_x0 = x0 >= 0 && x0 < wl, in_x1 = x0 + 1 >= 0 && x0 + 1 < wl;
      if (y0 >= 0 && y0 < hl) {
        const T* r = v + static_cast<long long>(y0) * wl * row;
        if (in_x0) s += load(r + static_cast<long long>(x0) * row) * (gx * gy);
        if (in_x1) s += load(r + static_cast<long long>(x0 + 1) * row) * (fx * gy);
      }
      if (y0 + 1 >= 0 && y0 + 1 < hl) {
        const T* r = v + static_cast<long long>(y0 + 1) * wl * row;
        if (in_x0) s += load(r + static_cast<long long>(x0) * row) * (gx * fy);
        if (in_x1) s += load(r + static_cast<long long>(x0 + 1) * row) * (fx * fy);
      }
      acc += a[i] / sum * s;
    }
  }
  out[head * D + c] = store<T>(acc);
}

template <typename T>
int launch(const void* value, const float* offsets, const float* logits, const float* ref,
           void* out, const Levels& lv, int B, int S, int Q, int H, int D, int L, int P,
           cudaStream_t s) {
  msda_kernel<T><<<B * Q, H * D, 0, s>>>(static_cast<const T*>(value), offsets, logits, ref,
                                         static_cast<T*>(out), lv, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. shapes: L (h, w) pairs; the
// levels' rows start one after another. Returns a cudaError_t code.
extern "C" int vdt_msda_launch(const void* value, const void* offsets, const void* logits,
                               const void* ref, void* out, int dtype, int B, int S, int Q,
                               int H, int D, int L, int P, const int* shapes, void* stream) {
  if (B == 0 || Q == 0) return 0;
  if (L < 1 || L > kMaxLevels || P < 1 || L * P > kMaxLevelPoints || H * D > 1024 ||
      H * D < 1 || static_cast<long long>(B) * Q > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv{};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return static_cast<int>(cudaErrorInvalidValue);
  const auto* off = static_cast<const float*>(offsets);
  const auto* lg = static_cast<const float*>(logits);
  const auto* rf = static_cast<const float*>(ref);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(value, off, lg, rf, out, lv, B, S, Q, H, D, L, P, s);
    case 1: return launch<__nv_bfloat16>(value, off, lg, rf, out, lv, B, S, Q, H, D, L, P, s);
    case 2: return launch<__half>(value, off, lg, rf, out, lv, B, S, Q, H, D, L, P, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
