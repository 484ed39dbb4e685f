// Row-aligned window extraction for Hopper (sm_90a): the micro-benchmark
// kernel of viso_tpu_torch/tools/bench_extract.py.
//
// Replaces tools/bench_extract.py::_extract_kernel (extract_windows_pallas),
// the TPU kernel whose grid of N / K steps each issued K async DMA copies
// of a (win + 8, win) tile into a (K, win + 8, win) VMEM block. Mosaic
// needs 8-aligned row offsets, so the tile origin is
//   base = clip(floor(c) - win / 2, 0, (W - win, H - (win + 8))),
//   base.y &= ~7,
// and the tile grows by 8 rows to keep the window covered. The contract is
// kept exactly (same origin rule, same tile shape, same K blocking), so the
// tool's sweep over K measures the same trade on this card: K is the number
// of windows ONE thread block copies, and the grid has N / K blocks.
//
// What bounds it on this card: nothing but latency. The largest call
// (N = 2048 windows of 32 x 24 f32) moves ~12.6 MB in all, a few
// microseconds of the card's 3.35 TB/s. So the design is one launch for
// all N windows, with the origins computed in the kernel (no separate
// launches for floor / clip / mask), and threads striding over the block's
// K * rows * win elements so that neighbouring threads read neighbouring
// columns of one image row and write neighbouring output words.
//
// The kernel allocates nothing; the Python wrapper
// (viso_tpu_torch/geometry/extract_aligned.py) allocates the tiles and the
// origins, checks device, dtype, shape and N % K, and raises on a non-zero
// return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void extract_aligned_kernel(
    const float* __restrict__ img, int H, int W,
    const float* __restrict__ centers, int win, int rows, int K,
    float* __restrict__ out, int* __restrict__ base_out) {
  extern __shared__ int sbase[];  // (K, 2): x0, y0 of the block's windows
  const int first = blockIdx.x * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const int n = first + j;
    int x0 = static_cast<int>(floorf(centers[2 * n])) - win / 2;
    int y0 = static_cast<int>(floorf(centers[2 * n + 1])) - win / 2;
    x0 = min(max(x0, 0), W - win);
    y0 = min(max(y0, 0), H - rows) & ~7;
    sbase[2 * j] = x0;
    sbase[2 * j + 1] = y0;
    base_out[2 * n] = x0;
    base_out[2 * n + 1] = y0;
  }
  __syncthreads();
  const int per = rows * win;
  const int total = K * per;
  float* dst = out + static_cast<int64_t>(first) * per;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i / per;
    const int rem = i - j * per;
    const int r = rem / win;
    const int c = rem - r * win;
    dst[i] = __ldg(img + static_cast<int64_t>(sbase[2 * j + 1] + r) * W +
                   sbase[2 * j] + c);
  }
}

}  // namespace

extern "C" int viso_extract_aligned(
    const float* img, int H, int W, const float* centers, int N,
    int win, int K, float* out, int* base_out, void* stream) {
  if (N > 0) {
    const int rows = win + 8;
    const int blocks = N / K;
    const int threads = 256;
    extract_aligned_kernel<<<blocks, threads, 2 * K * sizeof(int),
                             static_cast<cudaStream_t>(stream)>>>(
        img, H, W, centers, win, rows, K, out, base_out);
  }
  return static_cast<int>(cudaGetLastError());
}
