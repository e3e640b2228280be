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
// Design: every pixel is independent. The boxes' remaps compose, so the
// final value of pixel p is one pixel of the frame as it was before the
// call: start with q = p and, for j = K-1 down to 0, replace q by box j's
// source of q whenever q lies in box j. Pixels after the last box that holds
// p leave q alone, box k then moves q to its source, and each earlier box j
// that holds q moves it again, since box k read q as boxes 0..j left it.
// This needs no order between pixels, so all SMs work at any batch size,
// and every grid depends on B, H, W, C and K only, never on the boxes, which
// stay on the device.
//
// Two launches remove the one hazard, reading q after another block wrote
// it. A q that differs from p is always a source of the last box that moved
// it: a pixel of one of that box's max(1, b / level) source rows, inside its
// columns. prepare_kernel copies those rows of every box into a scratch
// frame (a row that two boxes share is copied twice with the same bytes).
// The scratch frame is as large as the batch (about 50 MB at 8 x 1080p RGB)
// although only those rows are filled, on purpose: a pixel lies at its own
// offset there, so the write needs no second index. A compact snapshot would
// save that memory.
// apply_kernel then writes every tile of the frame that a box meets: each
// pixel gets q's bytes from the scratch, or its own when q = p. It reads no
// pixel that another block writes, so it writes in place. The traffic is the bound's,
// plus the copy of the source rows (one row in `level`, read and written)
// and the pixels that share a tile with a box but lie in none, read and
// written back.
//
// apply_kernel cuts the frame into tiles of kTileRows rows by tile_cols(C)
// pixels, one block each. A pixel walks only the boxes its walk can reach,
// not all K. prepare_kernel's other blocks build that list for each tile,
// one thread per tile, last box first, from a rectangle R that holds every q
// of the tile's pixels so far: R starts as the tile; a box that meets R
// joins the list, and R grows by the sources of R's part of the box. Each
// row of T is non-decreasing (both cv2 nearest maps floor), so those sources
// lie between the sources of the part's first and last rows and columns;
// the wrapper checks it for each table. A tile with an empty list (no box
// meets it) returns after one load.
//
// What is left of the time is latency and instructions, not bandwidth: a
// pixel's walk is a chain of dependent table loads, then a load of q. So
// each lane walks kRowsPerWarp pixels together; the block stages its tile in
// shared memory and stores it 16 bytes a thread where the frame's rows are
// 16-byte aligned (a byte at a time otherwise); the snapshot keeps
// kCopyUnroll 16-byte loads in flight a lane. Boxes come kMaxBoxes at a
// time: a frame with more takes several passes, each on the frame the
// previous one left, which keeps the box order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;
constexpr int kVec = 16;
constexpr int kRowsPerWarp = kTileRows / kWarps;  // a lane's pixels in flight at once
constexpr int kMaxBoxes = 128;
constexpr int kListBytes = 1 + kMaxBoxes;  // a tile's list: its length, then box indices
constexpr int kSlices = 4;  // snapshot blocks per box, each a run of its rows
constexpr int kCopyUnroll = 4;

// Pixels across a tile: whole pixels, a whole number of 16-byte segments
// and of warps (256, 256 and 384 bytes).
__host__ __device__ constexpr int tile_cols(int C) { return C == 1 ? 256 : 128; }

struct Box {
  int x1, y1, x2, y2;
  bool ok;
};

struct Geometry {
  int tiles_x, tiles_y;
  long long tiles;
  long long snapshot_bytes;  // the frames' size, rounded up to 16 bytes
};

Geometry geometry(int B, int H, int W, int C) {
  Geometry g;
  g.tiles_y = (H + kTileRows - 1) / kTileRows;
  g.tiles_x = (W + tile_cols(C) - 1) / tile_cols(C);
  g.tiles = static_cast<long long>(B) * g.tiles_y * g.tiles_x;
  g.snapshot_bytes = (static_cast<long long>(B) * H * W * C + kVec - 1) / kVec * kVec;
  return g;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Box i of the flat (B*K) list, clipped to the frame; ok when it is valid
// and not empty.
__device__ __forceinline__ Box load_box(const int32_t* __restrict__ boxes,
                                        const uint8_t* __restrict__ valid, size_t i, int H,
                                        int W) {
  const int32_t* b = boxes + i * 4;
  Box box;
  box.x1 = clampi(b[0], 0, W);
  box.y1 = clampi(b[1], 0, H);
  box.x2 = clampi(b[2], 0, W);
  box.y2 = clampi(b[3], 0, H);
  box.ok = valid[i] && box.x2 > box.x1 && box.y2 > box.y1;
  return box;
}

// Copies box b's source rows in [t_begin, t_end) of its extent, inside its
// columns, from the frame at base to the scratch frame at the same place.
__device__ void copy_source_rows(const uint8_t* __restrict__ frames,
                                 uint8_t* __restrict__ snapshot, const Box& b,
                                 const int16_t* __restrict__ ty, size_t base, int row_bytes,
                                 int C, int t_begin, int t_end, int aligned) {
  int lo = b.x1 * C, hi = b.x2 * C;
  if (aligned) {  // whole 16-byte segments: the bytes around the box copy harmlessly
    lo = lo / kVec * kVec;
    hi = (hi + kVec - 1) / kVec * kVec;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Each warp takes 32 rows of the box at a time; a lane tells whether its
  // row is the first to read its source row, then the warp copies those.
  for (int t0 = t_begin + warp * 32; t0 < t_end; t0 += kWarps * 32) {
    const int t = t0 + lane;
    const int src = t < t_end ? ty[t] : 0;
    unsigned first = __ballot_sync(~0u, t < t_end && (t == 0 || src != ty[t - 1]));
    while (first) {
      const int l = __ffs(first) - 1;
      first &= first - 1;
      const size_t row = base + static_cast<size_t>(b.y1 + __shfl_sync(~0u, src, l)) * row_bytes;
      if (aligned) {
        for (int i = lo + lane * kVec; i < hi; i += kCopyUnroll * 32 * kVec) {
          uint4 v[kCopyUnroll];
#pragma unroll
          for (int u = 0; u < kCopyUnroll; ++u) {
            if (i + u * 32 * kVec < hi) {
              v[u] = *reinterpret_cast<const uint4*>(frames + row + i + u * 32 * kVec);
            }
          }
#pragma unroll
          for (int u = 0; u < kCopyUnroll; ++u) {
            if (i + u * 32 * kVec < hi) {
              *reinterpret_cast<uint4*>(snapshot + row + i + u * 32 * kVec) = v[u];
            }
          }
        }
      } else {
        for (int i = lo + lane; i < hi; i += 32) snapshot[row + i] = frames[row + i];
      }
    }
  }
}

// Blocks [0, B * nk * kSlices): each copies a slice of one box's source rows
// into the snapshot. The blocks after them: one thread per tile builds the
// tile's list of reachable boxes.
__global__ void __launch_bounds__(kThreads)
prepare_kernel(const uint8_t* __restrict__ frames, uint8_t* __restrict__ snapshot,
               uint8_t* __restrict__ lists, const int32_t* __restrict__ boxes,
               const uint8_t* __restrict__ valid, const int16_t* __restrict__ table, int B,
               int H, int W, int C, int K, int k0, int nk, int maxdim, int tiles_x,
               int tiles_y, int aligned) {
  __shared__ int4 box[kMaxBoxes];  // the frame's clipped boxes; invalid ones empty
  const int row_bytes = W * C;
  const int copy_blocks = B * nk * kSlices;
  if (static_cast<int>(blockIdx.x) < copy_blocks) {
    const int slice = blockIdx.x % kSlices;
    const int pair = blockIdx.x / kSlices;
    const int frame = pair / nk;
    const Box b = load_box(boxes, valid, static_cast<size_t>(frame) * K + k0 + pair % nk, H, W);
    if (!b.ok) return;
    const int bh = b.y2 - b.y1;
    copy_source_rows(frames, snapshot, b, table + static_cast<size_t>(bh) * maxdim,
                     static_cast<size_t>(frame) * H * row_bytes, row_bytes, C,
                     static_cast<int>(static_cast<long long>(bh) * slice / kSlices),
                     static_cast<int>(static_cast<long long>(bh) * (slice + 1) / kSlices),
                     aligned);
    return;
  }

  const int per_frame = tiles_x * tiles_y;
  const int blocks_per_frame = (per_frame + kThreads - 1) / kThreads;
  const int list_block = blockIdx.x - copy_blocks;
  const int frame = list_block / blocks_per_frame;
  for (int j = threadIdx.x; j < nk; j += kThreads) {
    const Box b = load_box(boxes, valid, static_cast<size_t>(frame) * K + k0 + j, H, W);
    // An empty box contains no pixel and meets no rectangle.
    box[j] = b.ok ? make_int4(b.x1, b.y1, b.x2, b.y2) : make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  const int tile = (list_block - frame * blocks_per_frame) * kThreads + threadIdx.x;
  if (tile >= per_frame) return;
  const int row0 = tile / tiles_x * kTileRows;
  const int col0 = tile % tiles_x * tile_cols(C);
  int ry1 = row0, ry2 = min(row0 + kTileRows, H);
  int rx1 = col0, rx2 = min(col0 + tile_cols(C), W);
  uint8_t* list = lists + (static_cast<size_t>(frame) * per_frame + tile) * kListBytes;
  int n = 0;
  for (int j = nk - 1; j >= 0; --j) {
    const int4 b = box[j];
    if (b.x >= rx2 || b.z <= rx1 || b.y >= ry2 || b.w <= ry1) continue;
    const int16_t* ty = table + static_cast<size_t>(b.w - b.y) * maxdim;
    const int16_t* tx = table + static_cast<size_t>(b.z - b.x) * maxdim;
    const int sy1 = b.y + ty[max(ry1, b.y) - b.y];
    const int sy2 = b.y + ty[min(ry2, b.w) - 1 - b.y] + 1;
    const int sx1 = b.x + tx[max(rx1, b.x) - b.x];
    const int sx2 = b.x + tx[min(rx2, b.z) - 1 - b.x] + 1;
    ry1 = min(ry1, sy1);
    ry2 = max(ry2, sy2);
    rx1 = min(rx1, sx1);
    rx2 = max(rx2, sx2);
    list[1 + n++] = static_cast<uint8_t>(j);
  }
  list[0] = static_cast<uint8_t>(n);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
apply_kernel(uint8_t* frames, const uint8_t* __restrict__ snapshot,
             const uint8_t* __restrict__ lists, const int32_t* __restrict__ boxes,
             const uint8_t* __restrict__ valid, const int16_t* __restrict__ table, int H,
             int W, int K, int k0, int maxdim, int tiles_x, int tiles_y, int aligned) {
  __shared__ int4 reach[kMaxBoxes];  // the boxes the tile's walks can meet, last first
  __shared__ int2 trow[kMaxBoxes];   // their table offsets: T row of bh and bw less y1, x1
  constexpr int kCols = tile_cols(C);
  constexpr int kSegments = kCols * C / kVec;  // 16-byte segments in a tile row
  __shared__ __align__(16) uint8_t out[kTileRows][kCols * C];

  const uint8_t* list = lists + static_cast<size_t>(blockIdx.x) * kListBytes;
  const int n = list[0];
  if (n == 0) return;  // no box meets the tile

  const int row_bytes = W * C;
  const int per_frame = tiles_x * tiles_y;
  const int frame = blockIdx.x / per_frame;
  const int tile = blockIdx.x - frame * per_frame;
  const int row0 = tile / tiles_x * kTileRows, row1 = min(row0 + kTileRows, H);
  const int col0 = tile % tiles_x * kCols, col1 = min(col0 + kCols, W);
  const int byte0 = col0 * C, byte1 = col1 * C;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Box b = load_box(boxes, valid, static_cast<size_t>(frame) * K + k0 + list[1 + i], H, W);
    reach[i] = make_int4(b.x1, b.y1, b.x2, b.y2);
    trow[i] = make_int2((b.y2 - b.y1) * maxdim - b.y1, (b.x2 - b.x1) * maxdim - b.x1);
  }
  __syncthreads();

  // Warp w takes rows w, w + kWarps, ... of the tile, kRowsPerWarp of them
  // together, one lane per pixel column: the walks and loads of those
  // pixels are in flight at once. A pixel takes q's bytes from the snapshot
  // where q moved, else its own, which no other block writes.
  const size_t base = static_cast<size_t>(frame) * H * row_bytes;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int x = col0 + lane; x - lane < col1; x += 32) {
    int qy[kRowsPerWarp], qx[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      qy[u] = row0 + warp + u * kWarps;
      qx[u] = x;
    }
    for (int i = 0; i < n; ++i) {
      const int4 b = reach[i];
      const int2 o = trow[i];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        if (qx[u] >= b.x && qx[u] < b.z && qy[u] >= b.y && qy[u] < b.w) {
          qy[u] = b.y + table[o.x + qy[u]];
          qx[u] = b.x + table[o.y + qx[u]];
        }
      }
    }
    uint8_t v[kRowsPerWarp][C];
    bool in_tile[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int r = row0 + warp + u * kWarps;
      in_tile[u] = x < col1 && r < row1;
      if (in_tile[u]) {
        const size_t at = base + static_cast<size_t>(qy[u]) * row_bytes + qx[u] * C;
        const uint8_t* src = (qy[u] != r || qx[u] != x) ? snapshot + at : frames + at;
#pragma unroll
        for (int c = 0; c < C; ++c) v[u][c] = src[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      if (!in_tile[u]) continue;
      uint8_t* staged = &out[warp + u * kWarps][(x - col0) * C];
#pragma unroll
      for (int c = 0; c < C; ++c) staged[c] = v[u][c];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (row1 - row0) * kSegments; i += kThreads) {
    const int r = i / kSegments;
    const int c0 = byte0 + (i - r * kSegments) * kVec;
    if (c0 >= byte1) continue;
    const uint8_t* s = &out[r][c0 - byte0];
    uint8_t* d = frames + base + static_cast<size_t>(row0 + r) * row_bytes + c0;
    if (aligned && c0 + kVec <= byte1) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int k = 0; k < kVec && c0 + k < byte1; ++k) d[k] = s[k];
    }
  }
}

}  // namespace

// Bytes of scratch one call needs: the snapshot frame, then a list per tile.
extern "C" long long vdt_mosaic_scratch_bytes(int B, int H, int W, int C) {
  const Geometry g = geometry(B, H, W, C);
  return g.snapshot_bytes + g.tiles * kListBytes;
}

extern "C" int vdt_mosaic_launch(void* frames, const void* boxes, const void* valid,
                                 const void* table, void* scratch, int B, int H, int W,
                                 int C, int K, int maxdim, void* stream) {
  const Geometry g = geometry(B, H, W, C);
  if (g.tiles == 0 || K == 0) return 0;
  if (C < 1 || C > 3) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_frame = static_cast<long long>(g.tiles_x) * g.tiles_y;
  const long long list_blocks = B * ((per_frame + kThreads - 1) / kThreads);
  if (g.tiles > 0x7fffffff || static_cast<long long>(B) * kMaxBoxes * kSlices + list_blocks >
                                  0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_bytes = W * C;
  auto* f = static_cast<uint8_t*>(frames);
  auto* snap = static_cast<uint8_t*>(scratch);
  auto* lists = snap + g.snapshot_bytes;
  const int aligned = reinterpret_cast<uintptr_t>(frames) % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(snap) % kVec == 0 && row_bytes % kVec == 0;
  const auto* bx = static_cast<const int32_t*>(boxes);
  const auto* ok = static_cast<const uint8_t*>(valid);
  const auto* tab = static_cast<const int16_t*>(table);
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(g.tiles);
  for (int k0 = 0; k0 < K; k0 += kMaxBoxes) {
    const int nk = K - k0 < kMaxBoxes ? K - k0 : kMaxBoxes;
    const int prepare_grid = B * nk * kSlices + static_cast<int>(list_blocks);
    prepare_kernel<<<prepare_grid, kThreads, 0, s>>>(f, snap, lists, bx, ok, tab, B, H, W, C, K,
                                                     k0, nk, maxdim, g.tiles_x, g.tiles_y,
                                                     aligned);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (C == 1) {
      apply_kernel<1><<<grid, kThreads, 0, s>>>(f, snap, lists, bx, ok, tab, H, W, K, k0, maxdim,
                                                g.tiles_x, g.tiles_y, aligned);
    } else if (C == 2) {
      apply_kernel<2><<<grid, kThreads, 0, s>>>(f, snap, lists, bx, ok, tab, H, W, K, k0, maxdim,
                                                g.tiles_x, g.tiles_y, aligned);
    } else {
      apply_kernel<3><<<grid, kThreads, 0, s>>>(f, snap, lists, bx, ok, tab, H, W, K, k0, maxdim,
                                                g.tiles_x, g.tiles_y, aligned);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
