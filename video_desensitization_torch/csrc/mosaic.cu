// In-place per-box mosaic (pixelation) of a uint8 (B, H, W*C) batch.
//
// Replaces ops/pallas_mosaic.py::_mosaic_kernel of the JAX package. For box
// k = 0..K-1 of each frame, clipped to the frame and skipped when invalid or
// empty:
//
//   out[y, x, c] = cur[y1 + T[bh][y - y1], x1 + T[bw][x - x1], c]
//
// where cur is the frame after boxes 0..k-1 and T is the (maxdim+1, maxdim)
// int16 composed-remap table of ops/mosaic.py::composed_mosaic_table.
//
// Bound: bytes; there is no arithmetic worth counting. The least traffic
// writes each pixel whose source is another pixel once and reads each such
// source once: about area * C bytes written per box (its old values are
// never needed) and, since a box of extent b reads max(1, b / level) of its
// rows, about area * C / level read, in 32-byte sectors. chip_smoke.py
// counts it exactly on the run's boxes.
//
// Design: one block per frame walks its boxes in order, so box k+1 sees box
// k's writes after a __syncthreads(). The hazard is that a box reads its
// sources inside the region it overwrites. T[b][t] <= t for every extent
// (both cv2 nearest maps floor), so in row-major order within the box an
// element's source never lies after the element itself. The block therefore
// walks the box from its last element backwards in chunks of
// THREADS * ITEMS elements: every thread loads its chunk elements' sources
// into registers, the block synchronises, then every thread stores. Elements
// after the chunk are already written and are never read again; elements
// before it are still those of cur. No scratch buffer and no shared memory,
// at any H, W, C and level. The wrapper checks T[b][t] <= t for each table.
// One block per frame leaves most SMs idle at small batch; spreading a
// frame's boxes over several blocks is the first thing to improve.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr long kChunk = static_cast<long>(kThreads) * kItems;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
mosaic_kernel(uint8_t* __restrict__ frames, const int32_t* __restrict__ boxes,
              const uint8_t* __restrict__ valid, const int16_t* __restrict__ table,
              int H, int W, int C, int K, int maxdim) {
  const int b = blockIdx.x;
  uint8_t* frame = frames + static_cast<size_t>(b) * H * W * C;
  const long row_stride = static_cast<long>(W) * C;

  for (int k = 0; k < K; ++k) {
    const int32_t* box = boxes + (static_cast<size_t>(b) * K + k) * 4;
    const int x1 = clampi(box[0], 0, W);
    const int y1 = clampi(box[1], 0, H);
    const int x2 = clampi(box[2], 0, W);
    const int y2 = clampi(box[3], 0, H);
    // Uniform across the block: every thread skips the same boxes.
    if (!valid[static_cast<size_t>(b) * K + k] || x2 <= x1 || y2 <= y1) continue;

    const int bw = x2 - x1;
    const long box_row = static_cast<long>(bw) * C;
    const long n = static_cast<long>(y2 - y1) * box_row;
    const int16_t* ty = table + static_cast<size_t>(y2 - y1) * maxdim;
    const int16_t* tx = table + static_cast<size_t>(bw) * maxdim;
    uint8_t* origin = frame + y1 * row_stride + static_cast<long>(x1) * C;

    for (long end = n; end > 0; end -= kChunk) {
      const long start = end > kChunk ? end - kChunk : 0;
      uint8_t v[kItems];
      long dst[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const long e = start + static_cast<long>(i) * kThreads + threadIdx.x;
        dst[i] = -1;
        if (e < end) {
          const int r = static_cast<int>(e / box_row);
          const int rem = static_cast<int>(e - r * box_row);
          const int col = rem / C;
          const int c = rem - col * C;
          dst[i] = r * row_stride + static_cast<long>(col) * C + c;
          v[i] = origin[ty[r] * row_stride + static_cast<long>(tx[col]) * C + c];
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (dst[i] >= 0) origin[dst[i]] = v[i];
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int vdt_mosaic_launch(void* frames, const void* boxes, const void* valid,
                                 const void* table, int B, int H, int W, int C, int K,
                                 int maxdim, void* stream) {
  if (B > 0 && K > 0) {
    mosaic_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(frames), static_cast<const int32_t*>(boxes),
        static_cast<const uint8_t*>(valid), static_cast<const int16_t*>(table), H, W, C,
        K, maxdim);
  }
  return static_cast<int>(cudaGetLastError());
}
