// Row-aligned window extraction for Hopper (sm_90a): kernel K2, the
// micro-benchmark kernel of viso_tpu_torch/tools/bench_extract.py.
//
// Replaces tools/bench_extract.py::_extract_kernel (extract_windows_pallas),
// the TPU kernel whose grid of N / K steps each issued K async DMA copies
// of a (win + 8, win) tile into a (K, win + 8, win) VMEM block. Mosaic
// needs 8-aligned row offsets, so the tile origin is
//   base = clip(floor(c) - win / 2, 0, (W - win, H - (win + 8))),
//   base.y &= ~7,
// and the tile grows by 8 rows to keep the window covered. The contract is
// kept exactly (same origin rule, same tile shape, origins written out).
// K was the TPU's grid step; here it sets nothing: the launch geometry
// depends on N and the card only, so the time is flat in K.
//
// What bounds it on this card: bytes, if anything. The largest call
// (N = 2048 tiles of 32 x 24 f32) reads and writes 12.6 MB, 3.8 us at
// 3.35 TB/s. The loads go through Hopper's Tensor Memory Accelerator: a
// 2-D tensor map over the image, one cp.async.bulk.tensor load per tile
// into a ring of shared-memory stages, completed on mbarriers, issued by
// one lane that keeps the whole ring in flight. TMA takes a box only at a
// 16-byte aligned first column (an unaligned start is an illegal
// instruction on the H100), and a tile's x0 is any column, so each load
// takes the box of (win + 8) rows and win + 4 columns at x0 & ~3, and the
// warp writes the tile's win columns from shared memory to its contiguous
// output slot with coalesced stores. A persistent grid of a few one-warp
// blocks per SM walks the tiles. The warp's 32 lanes first compute the
// block's tile origins (torch's float -> int32 cast on the card: cvt.rzi,
// NaN -> 0, saturating; the subtraction wraps), write them out and keep
// them in shared memory, so the issuing lane never waits on a centre's
// load before a tile's copy.
//
// The tensor map is encoded on the host for each call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion
// so the library needs no -lcuda. The kernel allocates nothing; the Python
// wrapper (viso_tpu_torch/geometry/extract_aligned.py) allocates the tiles
// and the origins, checks device, dtype, shape, N % K and what TMA needs
// (16-byte aligned image and row pitch, box rows of 16-byte multiples, a
// box that fits a stage), and raises on a non-zero return.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 8;      // tiles in flight per block
constexpr int kBlocksPerSM = 4;
constexpr int kStageAlign = 128;   // TMA's shared-memory alignment
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMaxPerBlock = 512;   // tile origins a block keeps

// Return codes besides cudaError_t values.
constexpr int kErrNoEncoder = -1;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = -2;     // cuTensorMapEncodeTiled refused the map
constexpr int kErrTileSize = -3;   // a box does not fit one stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int aligned_start(float c, int half, int hi) {
  const int f = __float2int_rz(floorf(c));
  const int b = static_cast<int>(static_cast<unsigned>(f) - static_cast<unsigned>(half));
  return min(max(b, 0), hi);
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(32) extract_aligned_kernel(
    const __grid_constant__ CUtensorMap tmap, int H, int W,
    const float* __restrict__ centers, int N, int win, int rows,
    int per_block, int stages, int stage_bytes, float* __restrict__ out,
    int* __restrict__ base_out) {
  // Dynamic shared memory: this block's tile origins, then the ring.
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  int2* origin = reinterpret_cast<int2*>(smem_raw);
  const int lane = threadIdx.x;
  // Tile i of this block is tile blockIdx.x + i * gridDim.x.
  const int count = (N - 1 - blockIdx.x) / gridDim.x + 1;

  // All lanes: the origins of this block's tiles, into shared memory and
  // out to base_out.
  for (int i = lane; i < count; i += 32) {
    const int t = blockIdx.x + i * gridDim.x;
    const int x0 = aligned_start(__ldg(centers + 2 * t), win / 2, W - win);
    const int y0 = aligned_start(__ldg(centers + 2 * t + 1), win / 2, H - rows) & ~7;
    origin[i] = make_int2(x0, y0);
    base_out[2 * t] = x0;
    base_out[2 * t + 1] = y0;
  }
  const int pitch = win + 4;   // the box's columns
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (smem_u32(origin + per_block) + kStageAlign - 1) & ~(kStageAlign - 1);
  const uint32_t box_bytes = static_cast<uint32_t>(rows * pitch * 4);
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // Tile i's box into stage i % stages (lane 0).
  auto load = [&](int i) {
    const uint32_t bar = smem_u32(&full[i % stages]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(box_bytes) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(ring + (i % stages) * stage_bytes),
        "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(bar), "r"(origin[i].x & ~3),
        "r"(origin[i].y) : "memory");
  };
  if (lane == 0) {
    for (int i = 0; i < count && i < stages; ++i) load(i);
  }

  // Lane -> (row offset, column) of the copy-out: a tile of at most 16
  // columns takes rpp = 32 / win rows per pass (no division per element).
  int rpp = 1, lr = 0, lc = lane;
  if (win <= 16) {
    rpp = 32 / win;
    lr = lane / win;
    lc = lane - lr * win;
    if (lr >= rpp) lc = win;   // idle lane
  }
  for (int i = 0; i < count; ++i) {
    const int s = i % stages;
    wait_parity(smem_u32(&full[s]), (i / stages) & 1);
    const float* box = reinterpret_cast<const float*>(smem_raw + (ring - raw) + s * stage_bytes) +
                       (origin[i].x & 3);
    float* dst = out + static_cast<int64_t>(blockIdx.x + i * gridDim.x) * rows * win;
    for (int c = lc; c < win; c += 32) {
      for (int r = lr; r < rows; r += rpp) dst[r * win + c] = box[r * pitch + c];
    }
    __syncwarp();   // every lane has read stage s
    if (lane == 0 && i + stages < count) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(i + stages);
    }
  }
}

// cuTensorMapEncodeTiled's type (CUDA 12.0 ABI).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

}  // namespace

// N tiles of (win + 8, win) from img (H, W) at centers (N, 2): out
// (N, win + 8, win) and base_out (N, 2). K is not an argument: it never
// shaped the copy on this card.
extern "C" int viso_extract_aligned(
    const float* img, int H, int W, const float* centers, int N,
    int win, float* out, int* base_out, void* stream) {
  if (N <= 0) return 0;
  const int rows = win + 8;
  // A persistent grid of a few blocks per SM; more only if a block would
  // hold more origins than kMaxPerBlock.
  int blocks = kBlocksPerSM * sm_count();
  if (blocks > N) blocks = N;
  if (blocks < (N + kMaxPerBlock - 1) / kMaxPerBlock) {
    blocks = (N + kMaxPerBlock - 1) / kMaxPerBlock;
  }
  const int per_block = (N + blocks - 1) / blocks;
  const int box_bytes = rows * (win + 4) * 4;
  const int stage_bytes = (box_bytes + kStageAlign - 1) / kStageAlign * kStageAlign;
  const int ring_at = per_block * 8 + kStageAlign;   // origins, then alignment slack
  int stages = (kSmemBytes - ring_at) / stage_bytes;
  if (stages < 1) return kErrTileSize;
  if (stages > kMaxStages) stages = kMaxStages;

  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap tmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(win + 4), static_cast<cuuint32_t>(rows)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(img), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return kErrEncode;
  }
  const size_t smem = static_cast<size_t>(ring_at) + static_cast<size_t>(stages) * stage_bytes;
  extract_aligned_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      tmap, H, W, centers, N, win, rows, per_block, stages, stage_bytes, out, base_out);
  return static_cast<int>(cudaGetLastError());
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// An empty kernel: the card's launch floor, timed beside the copy.
extern "C" int viso_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
