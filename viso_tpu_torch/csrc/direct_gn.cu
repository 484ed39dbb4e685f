// Direct photometric Gauss-Newton over one pyramid level, for Hopper
// (sm_90a): the level pass of direct tracking in iters + 1 launches.
//
// Replaces no TPU kernel: viso_tpu/ops/direct.py::_level_pass_cached is
// jnp code that XLA fuses into a few loops on the TPU. On the card the same
// pass ran as plain PyTorch ops inside the track program's CUDA graph,
// about 170 kernels of a few hundred to 65,536 elements per GN step and
// 4,764 in a tracked frame's four levels, each far below any roofline.
//
// The pass is bit-equal to the plain version on the card
// (viso_tpu_torch/ops/direct.py::level_pass_plain): the tracking step
// downstream (the keyframe's triangulation, the window BA's accept /
// reject decisions) turns a last-bit change of the pose into millimetres,
// so a pass that only reorders float32 sums does not give the same
// trajectory. Each launch therefore does one GN step with every
// floating-point operation of the plain pass, in its order, as the card's
// libraries take it:
//   * elementwise ops as ATen's kernels do them, one rounding each (a
//     division by a Python scalar is a product with its reciprocal, a
//     Python scalar over a tensor a reciprocal times the scalar);
//   * the (N, 3) x (3, 3) einsum and both passes of the separable
//     bilinear sample as cuBLAS's fma chains in k order; 3 x 3 products as
//     fma(a1, b1, a0 b0) + a2 b2;
//   * every torch.sum over the patch pixels as ATen's one-block reduction
//     (512 lanes of 4 interleaved accumulators, a shared-memory tree, a
//     warp shuffle tree); the trace and 3-element sums in ATen's order;
//   * H = J6w J6^T as cuBLAS's split-K gemm: min(128, N) contiguous
//     slices of fma chains added in slice order;
//   * torch.linalg.solve_ex as cuSOLVER's LU: the first largest pivot,
//     multipliers by the pivot's reciprocal, fma updates, column-wise back
//     substitution by division.
// Only b = -(J6w r) stays with cuBLAS (its dot kernel's order is not
// reproduced): the launch writes J6w and r, the wrapper calls the same
// `J6w @ rf` as the plain pass between launches, and the next launch takes
// its result, solves and updates the pose before its own step. These
// orders were read off the card's libraries (torch 2.11 built for CUDA
// 12.8, cuBLAS 12.9.2, on an H100) at the track's shapes (1,024 and 256
// points); the card tests hold the kernel to the plain pass bit for bit
// there, and the wrapper warns when it loads under other versions
// (ops/direct.py::ORDERS_READ_ON).
//
// What bounds it on this card: the latency of a step's dependent passes,
// not bytes or operations (a launch reads its windows, templates and
// Jacobian once, ~2.5 MB at the largest level, and does ~250 flops a patch
// pixel). One thread-block cluster per launch (up to 16 CTAs, the
// non-portable cluster size) splits the points, 64 at most a CTA, each
// CTA's windows in shared memory. Each sum's 512 reduction lanes are split
// over the CTAs (a lane reads its strided chunks through L2) and every CTA
// finishes the tree from the same lanes, so all hold the same bits; the
// gemm's slices run where their pixels are, from J6w and J6 staged in
// shared memory once the windows are sampled. The passes meet at cluster
// barriers. Every CTA computes the same pose update from the same numbers;
// CTA 0 writes the state. No float atomics: a replay gives the same bits
// every time.
//
// The kernel allocates nothing. The Python wrapper
// (viso_tpu_torch/ops/direct.py::launch) allocates state, scratch and
// outputs, checks device, dtype, shape and contiguity, calls the gemv
// between launches, and raises on a non-zero return.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = 4;                                  // half_patch
constexpr int kPatchPx = 4 * kHalf * kHalf;               // 8 x 8 pixels
constexpr int kMaxPoints = 64;                            // points per CTA
constexpr int kPxPerThread = kMaxPoints * kPatchPx / kThreads;   // 8
constexpr int kSlotStep = kThreads / kPatchPx;            // 8 points between a thread's pixels
constexpr int kMaxWin = 24;
constexpr int kMaxCluster = 16;
constexpr int kSplits = 128;                              // cuBLAS's split-K slices for H, at most
constexpr int kLanes = 512;                               // ATen's reduction lanes, at most
constexpr int kTilePx = kMaxPoints * kPatchPx;            // a CTA's patch pixels, at most
constexpr int kGemmWarps = 8;                             // warps that run the gemm's chains
// Dynamic shared memory: the CTA's windows while it samples, then its
// pixels' J6w and J6 ((pixel, 6) each) while it runs the gemm's chains.
constexpr size_t kMaxDynamicSmem = sizeof(float) * 12 * kTilePx;
static_assert(kMaxPoints * kMaxWin * kMaxWin <= 12 * kTilePx, "windows fit the tiles");

// The state between launches (floats): the iterate, the best pose and
// cost so far, the damped system.
constexpr int kR = 0, kT = 9, kBestR = 12, kBestT = 21, kBestCost = 24, kHd = 25;
constexpr int kStateFloats = 64;
// Scratch: arrays of M floats, the gemm's slice partials, the reduction
// lanes of each sum, the CTAs' counts of valid points.
constexpr int kT1 = 0, kI1 = 1, kCov = 2, kVar = 3, kWrr = 4, kWf = 5, kArrays = 6;

struct Args {
  const float* windows;         // (n, win, win) K1 windows of the current level
  const int* base;              // (n, 2) their origins (x0, y0)
  const float* T;               // (n, 8, 8) template patches
  const float* J6;              // (6, n * 64) frozen photometric Jacobian
  const unsigned char* ref_ok;  // (n,) template validity (bool)
  const float* d_ref;           // (n,) reference depths
  const float* points;          // (n, 3) world points
  const float* R0;              // (3, 3) initial pose
  const float* t0;              // (3,)
  const float* Jr;              // (6,) J6w @ rf of the previous step (step > 0)
  float* state;                 // kStateFloats
  float* scratch;               // viso_direct_gn_scratch_floats(n)
  float* J6w;                   // (6, M) for the gemv
  float* rf;                    // (M,)
  float* R_out;                 // (3, 3) best pose (last step)
  float* t_out;                 // (3,)
  float* cost_out;              // ()
  int n, win, height, width, iters, affine, per_cta, step;
  float fx, fy, cx, cy, min_depth, huber, lm_damping, scale_hi;
};

struct Shared {
  float R[9], t[3];             // the step's iterate
  float du[kMaxPoints], dv[kMaxPoints];   // projection less the window origin
  float scale[kMaxPoints], ok[kMaxPoints];
  float red[2][kLanes];         // two sums' lanes for ATen's tree
  float sum[2];
  float H[36];
  int count;
};

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// cuBLAS's 3-term dot of a 3 x 3 product or a (3, 3) x (3,) einsum.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return add(fmaf(a1, b1, mul(a0, b0)), mul(a2, b2));
}

// Barrier over the cluster; global writes before it are seen after it.
__device__ __forceinline__ void cluster_barrier(const cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

// torch.sum of an array of m floats (m a multiple of 4, at least 128,
// 16-byte aligned) on the card is ATen's vectorized one-block reduction:
// `width` lanes (a power of two, at most 512 and at most m / 4), lane j
// adding the float4 chunks j, j + width, ... into 4 accumulators taken
// together as ((v0 + v1) + v2) + v3; then a shared-memory tree halving
// the lanes down to 32, then a warp's shuffle tree. The lanes are split
// over the cluster's CTAs (`lanes`); `reduce_tree` finishes a sum from
// the lanes in every CTA alike.
__device__ __forceinline__ int sum_width(int m) {
  int width = 32;
  while (width * 2 <= m / 4 && width * 2 <= kLanes) width *= 2;
  return width;
}

__device__ float lane_sum(const float* x, int m, int width, int lane) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
#pragma unroll 8
  for (int i = lane; i < m / 4; i += width) {
    const float4 q = __ldcg(x4 + i);
    v0 = add(v0, q.x);
    v1 = add(v1, q.y);
    v2 = add(v2, q.z);
    v3 = add(v3, q.w);
  }
  return add(add(add(v0, v1), v2), v3);
}

// This CTA's share of the lanes of two sums of m floats, x0 and x1: lane
// values to out0 and out1 (global), by threads [t0, t0 + nt).
__device__ void lanes(const float* x0, const float* x1, int m, float* out0, float* out1,
                      int rank, int ctas, int t0, int nt) {
  const int width = sum_width(m);
  const int per = (width + ctas - 1) / ctas;
  const int lo = rank * per, cnt = max(0, min(per, width - lo));
  for (int e = threadIdx.x - t0; e >= 0 && e < 2 * cnt; e += nt) {
    const int which = e / cnt, lane = lo + e % cnt;
    const float v = lane_sum(which ? x1 : x0, m, width, lane);
    (which ? out1 : out0)[lane] = v;
  }
}

// Both sums from their lanes (global; written before a cluster barrier),
// in ATen's tree order, by the whole CTA: sh.sum[0], sh.sum[1].
__device__ void reduce_tree(const float* l0, const float* l1, int m, Shared& sh) {
  const int width = sum_width(m);
  const int which = threadIdx.x / (kThreads / 2), j = threadIdx.x % (kThreads / 2);
  float* red = sh.red[which];
  const float* src = which ? l1 : l0;
  for (int e = j; e < width; e += kThreads / 2) red[e] = __ldcg(src + e);
  __syncthreads();
  float v = j < width ? red[j] : 0.0f;
  for (int off = width / 2; off >= 32; off >>= 1) {
    if (j < off) v = add(v, red[j + off]);
    __syncthreads();
    if (j < off) red[j] = v;
    __syncthreads();
  }
  if (j < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, off));
    if (j == 0) sh.sum[which] = v;
  }
  __syncthreads();
}

// x = A^-1 b, cuSOLVER's getrf / getrs for a 6 x 6 system. A zero pivot
// gives non-finite values, which the caller turns into a zero step.
__device__ void solve6(float (&A)[6][6], float (&b)[6], float (&x)[6]) {
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float big = fabsf(A[c][c]);
    for (int r = c + 1; r < 6; ++r) {
      if (fabsf(A[r][c]) > big) {
        big = fabsf(A[r][c]);
        p = r;
      }
    }
    if (p != c) {
      for (int j = 0; j < 6; ++j) {
        const float tmp = A[c][j];
        A[c][j] = A[p][j];
        A[p][j] = tmp;
      }
      const float tmp = b[c];
      b[c] = b[p];
      b[p] = tmp;
    }
    const float inv = __fdiv_rn(1.0f, A[c][c]);
    for (int r = c + 1; r < 6; ++r) A[r][c] = mul(A[r][c], inv);
    for (int r = c + 1; r < 6; ++r) {
      for (int j = c + 1; j < 6; ++j) A[r][j] = fmaf(-A[r][c], A[c][j], A[r][j]);
    }
  }
  for (int c = 0; c < 6; ++c) {
    for (int r = c + 1; r < 6; ++r) b[r] = fmaf(-A[r][c], b[c], b[r]);
  }
  for (int r = 0; r < 6; ++r) x[r] = b[r];
  for (int c = 5; c >= 0; --c) {
    x[c] = __fdiv_rn(x[c], A[c][c]);
    for (int r = 0; r < c; ++r) x[r] = fmaf(-A[r][c], x[c], x[r]);
  }
}

// (R, t) <- exp(xi) (R, t): se3.left_update, op for op.
__device__ void left_update(const float (&xi)[6], float* R, float* t) {
  const float eps = 1e-8f;
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float p0 = mul(w0, w0), p1 = mul(w1, w1), p2 = mul(w2, w2);
  const float th2 = add(add(p0, p2), p1);          // ATen's sum of 3
  const float th = __fsqrt_rn(add(th2, eps));
  const bool small = th2 < 1e-4f;
  const float s = sinf(th), c = cosf(th);
  const float A = small ? sub(1.0f, mul(th2, 1.0f / 6.0f)) : __fdiv_rn(s, th);
  const float B = small ? sub(0.5f, mul(th2, 1.0f / 24.0f))
                        : __fdiv_rn(sub(1.0f, c), add(th2, eps));
  const float C = small ? sub(static_cast<float>(1.0 / 6.0), mul(th2, 1.0f / 120.0f))
                        : __fdiv_rn(sub(th, s), add(mul(th2, th), eps));
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float W2[3][3], dR[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = dot3(W[i][0], W[0][j], W[i][1], W[1][j], W[i][2], W[2][j]);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      dR[i][j] = add(add(eye, mul(A, W[i][j])), mul(B, W2[i][j]));
      V[i][j] = add(add(eye, mul(B, W[i][j])), mul(C, W2[i][j]));
    }
  }
  float dt[3], Rn[9], tn[3];
  for (int i = 0; i < 3; ++i) dt[i] = dot3(V[i][0], xi[0], V[i][1], xi[1], V[i][2], xi[2]);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = dot3(dR[i][0], R[j], dR[i][1], R[3 + j], dR[i][2], R[6 + j]);
    tn[i] = add(dot3(dR[i][0], t[0], dR[i][1], t[1], dR[i][2], t[2]), dt[i]);
  }
  for (int k = 0; k < 9; ++k) R[k] = Rn[k];
  for (int k = 0; k < 3; ++k) t[k] = tn[k];
}

// One axis of the separable hat-weight sample at coordinate c (clamped to
// [0, win - 1]): grid rows i0 and i1 with their weights; no i1 at the last
// row (its weight is 0).
struct Taps {
  int i0, i1;
  float w0, w1;
  bool two;
};

__device__ __forceinline__ Taps taps(float c, int win) {
  Taps t;
  const float f = floorf(c);
  t.i0 = min(max(static_cast<int>(f), 0), win - 1);   // NaN -> 0, its weights stay NaN
  t.w0 = sub(1.0f, fabsf(sub(c, static_cast<float>(t.i0))));
  t.two = t.i0 + 1 <= win - 1;
  t.i1 = t.two ? t.i0 + 1 : t.i0;
  t.w1 = t.two ? sub(1.0f, fabsf(sub(c, static_cast<float>(t.i1)))) : 0.0f;
  return t;
}

// The sample: cuBLAS's fma chains over the window's rows, then its columns.
__device__ __forceinline__ float sample(const float* w, int win, const Taps& tx, const Taps& ty) {
  float c0 = mul(ty.w0, w[ty.i0 * win + tx.i0]);
  float c1 = mul(ty.w0, w[ty.i0 * win + tx.i1]);
  if (ty.two) {
    c0 = fmaf(ty.w1, w[ty.i1 * win + tx.i0], c0);
    c1 = fmaf(ty.w1, w[ty.i1 * win + tx.i1], c1);
  }
  float v = mul(c0, tx.w0);
  if (tx.two) v = fmaf(c1, tx.w1, v);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1) direct_gn_kernel(Args a) {
  const cg::cluster_group cluster = cg::this_cluster();
  __shared__ Shared sh;
  extern __shared__ float4 dyn_smem[];
  float* wins = reinterpret_cast<float*>(dyn_smem);
  const int tid = threadIdx.x;
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int first = rank * a.per_cta;
  const int n_loc = max(0, min(a.per_cta, a.n - first));
  const int win = a.win, ww = win * win;
  const int m = a.n * kPatchPx;
  const bool last = a.step == a.iters;
  float* arrays = a.scratch;
  float* partials = a.scratch + kArrays * m;
  float* lane_out = partials + kSplits * 36;           // kArrays x kLanes
  float* counts = lane_out + kArrays * kLanes;

  // The iterate: the input pose, or the previous step's solve and update
  // (by one thread, while the others load the windows).
  if (tid == 0) {
    if (a.step == 0) {
      for (int k = 0; k < 9; ++k) sh.R[k] = __ldg(a.R0 + k);
      for (int k = 0; k < 3; ++k) sh.t[k] = __ldg(a.t0 + k);
    } else {
      for (int k = 0; k < 9; ++k) sh.R[k] = __ldcg(a.state + kR + k);
      for (int k = 0; k < 3; ++k) sh.t[k] = __ldcg(a.state + kT + k);
      float Hd[6][6], b[6], xi[6];
      for (int i = 0; i < 6; ++i) {
        for (int j = 0; j < 6; ++j) Hd[i][j] = __ldcg(a.state + kHd + 6 * i + j);
        b[i] = -__ldcg(a.Jr + i);
      }
      solve6(Hd, b, xi);
      bool finite = true;
      for (int i = 0; i < 6; ++i) finite = finite && isfinite(xi[i]);
      if (!finite) {
        for (int i = 0; i < 6; ++i) xi[i] = 0.0f;
      }
      left_update(xi, sh.R, sh.t);
    }
    sh.count = 0;
  }
  // This CTA's windows.
  {
    const float* src = a.windows + static_cast<int64_t>(first) * ww;
    const int total = n_loc * ww;
    if ((ww & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int e = tid; e < total / 4; e += kThreads) dyn_smem[e] = __ldg(src4 + e);
    } else {
      for (int e = tid; e < total; e += kThreads) wins[e] = __ldg(src + e);
    }
  }
  __syncthreads();

  // Per point: transform, project, the depth-ratio scale and the gates.
  const float border = static_cast<float>(kHalf + 1);
  if (tid < n_loc) {
    const int g = first + tid;
    const float X = __ldg(a.points + 3 * g), Y = __ldg(a.points + 3 * g + 1);
    const float Z = __ldg(a.points + 3 * g + 2);
    const float* R = sh.R;
    const float* t = sh.t;
    const float px = add(fmaf(R[2], Z, fmaf(R[1], Y, mul(R[0], X))), t[0]);
    const float py = add(fmaf(R[5], Z, fmaf(R[4], Y, mul(R[3], X))), t[1]);
    const float pz = add(fmaf(R[8], Z, fmaf(R[7], Y, mul(R[6], X))), t[2]);
    const float eps = 1e-6f;
    const float zs = fabsf(pz) < eps ? (pz < 0.0f ? -eps : eps) : pz;
    const float inv_z = mul(__fdiv_rn(1.0f, zs), 1.0f);
    const float u = add(mul(mul(a.fx, px), inv_z), a.cx);
    const float v = add(mul(mul(a.fy, py), inv_z), a.cy);
    const float s = clamp(__fdiv_rn(__ldg(a.d_ref + g), clamp_lo(pz, a.min_depth)), 0.5f,
                          a.scale_hi);
    const float ext = add(mul(static_cast<float>(kHalf), s), 1.0f);
    const float du = sub(u, static_cast<float>(__ldg(a.base + 2 * g)));
    const float dv = sub(v, static_cast<float>(__ldg(a.base + 2 * g + 1)));
    const float hi = sub(sub(static_cast<float>(win), ext), 1.0f);
    const bool in_win = du >= ext && dv >= ext && du <= hi && dv <= hi;
    const bool inside = u >= border && u < static_cast<float>(a.width - 1 - (kHalf + 1)) &&
                        v >= border && v < static_cast<float>(a.height - 1 - (kHalf + 1));
    const bool ok = a.ref_ok[g] != 0 && pz > a.min_depth && inside && in_win;
    sh.du[tid] = du;
    sh.dv[tid] = dv;
    sh.scale[tid] = s;
    sh.ok[tid] = ok ? 1.0f : 0.0f;
    if (ok) atomicAdd(&sh.count, 1);   // an integer count: exact in any order
  }
  __syncthreads();
  if (tid == 0) counts[rank] = static_cast<float>(sh.count);

  // Per pixel: the scaled patch sample. Thread tid holds pixel q of the
  // points tid / 64 + 8 k, k < 8.
  const int q = tid & (kPatchPx - 1);
  const int slot0 = tid / kPatchPx;
  const float row_off = static_cast<float>(q / (2 * kHalf) - kHalf);
  const float col_off = static_cast<float>(q % (2 * kHalf) - kHalf);
  const float win_hi = static_cast<float>(win - 1);
  float Tv[kPxPerThread], I[kPxPerThread], okp[kPxPerThread];
  // pix[k]: the index of the thread's k-th pixel in the M-long arrays, -1
  // past this CTA's points.
  int pix[kPxPerThread];
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int slot = slot0 + kSlotStep * k;
    Tv[k] = I[k] = okp[k] = 0.0f;
    pix[k] = -1;
    if (slot < n_loc) {
      pix[k] = (first + slot) * kPatchPx + q;
      Tv[k] = __ldg(a.T + pix[k]);
      const float s = sh.scale[slot];
      const float us = clamp(add(sh.du[slot], mul(col_off, s)), 0.0f, win_hi);
      const float vs = clamp(add(sh.dv[slot], mul(row_off, s)), 0.0f, win_hi);
      I[k] = sample(wins + slot * ww, win, taps(us, win), taps(vs, win));
      okp[k] = sh.ok[slot];
    }
  }

  // Affine gain / bias: r = I - (g T + (mI - g mT)).
  float gain = 1.0f, mT = 0.0f, mI = 0.0f;
  if (a.affine) {
#pragma unroll
    for (int k = 0; k < kPxPerThread; ++k) {
      if (pix[k] < 0) continue;
      arrays[kT1 * m + pix[k]] = mul(Tv[k], okp[k]);
      arrays[kI1 * m + pix[k]] = mul(I[k], okp[k]);
    }
    cluster_barrier(cluster);
    lanes(arrays + kT1 * m, arrays + kI1 * m, m, lane_out + kT1 * kLanes,
          lane_out + kI1 * kLanes, rank, ctas, 0, kThreads);
    cluster_barrier(cluster);
    reduce_tree(lane_out + kT1 * kLanes, lane_out + kI1 * kLanes, m, sh);
    float n_ok = 0.0f;
    for (int c = 0; c < ctas; ++c) n_ok += __ldcg(counts + c);
    const float wsum = clamp_lo(mul(mul(n_ok, 8.0f), 8.0f), 1.0f);
    mT = __fdiv_rn(sh.sum[0], wsum);
    mI = __fdiv_rn(sh.sum[1], wsum);
#pragma unroll
    for (int k = 0; k < kPxPerThread; ++k) {
      if (pix[k] < 0) continue;
      const float dT = mul(sub(Tv[k], mT), okp[k]);
      arrays[kCov * m + pix[k]] = mul(dT, sub(I[k], mI));
      arrays[kVar * m + pix[k]] = mul(dT, dT);
    }
    cluster_barrier(cluster);
    lanes(arrays + kCov * m, arrays + kVar * m, m, lane_out + kCov * kLanes,
          lane_out + kVar * kLanes, rank, ctas, 0, kThreads);
    cluster_barrier(cluster);
    reduce_tree(lane_out + kCov * kLanes, lane_out + kVar * kLanes, m, sh);
    gain = clamp(__fdiv_rn(sh.sum[0], clamp_lo(sh.sum[1], 1e-3f)), 0.5f, 2.0f);
  }

  // Huber-weighted residuals: wf, wf rf rf, and for the gemv J6w and rf.
  // The windows are sampled: their shared memory takes the CTA's pixels'
  // J6w and J6, (pixel, 6) each, for the gemm's chains.
  __syncthreads();
  float* tile_w = wins;
  float* tile_j = wins + 6 * kTilePx;
  const float offset = sub(mI, mul(gain, mT));
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    if (pix[k] < 0) continue;
    const int px = pix[k];
    const float r = a.affine ? sub(I[k], add(mul(gain, Tv[k]), offset)) : sub(I[k], Tv[k]);
    const float ar = fabsf(r);
    const float hub = ar <= a.huber ? 1.0f : mul(__fdiv_rn(1.0f, clamp_lo(ar, 1e-9f)), a.huber);
    const float w = mul(hub, okp[k]);
    arrays[kWf * m + px] = w;
    arrays[kWrr * m + px] = mul(mul(w, r), r);
    if (!last) {
      a.rf[px] = r;
      const int loc = 6 * (px - first * kPatchPx);
      for (int c = 0; c < 6; ++c) {
        const float j = __ldg(a.J6 + c * m + px);
        const float jw = mul(j, w);
        a.J6w[c * m + px] = jw;
        tile_w[loc + c] = jw;
        tile_j[loc + c] = j;
      }
    }
  }
  cluster_barrier(cluster);

  // The cost's sums' lanes, on the warps the gemm leaves free.
  lanes(arrays + kWrr * m, arrays + kWf * m, m, lane_out + kWrr * kLanes,
        lane_out + kWf * kLanes, rank, ctas, last ? 0 : 32 * kGemmWarps,
        last ? kThreads : kThreads - 32 * kGemmWarps);
  // H = J6w J6^T: the gemm's slices, each an fma chain per output over
  // `len` consecutive pixels in order. A slice is run by one warp of the
  // CTA that holds its first pixel: lane l < 18 takes outputs (i, j) and
  // (i + 3, j), i = l / 6, j = l % 6, from the tiles in shared memory (a
  // slice that runs on into the next CTA's pixels reads that CTA's tiles
  // through the cluster's distributed shared memory).
  const int splits = min(kSplits, max(1, m / kPatchPx));
  const int len = (m + splits - 1) / splits;
  if (!last && tid < 32 * kGemmWarps) {
    const int cta_px = a.per_cta * kPatchPx;
    const int lo = first * kPatchPx, hi = min(m, lo + cta_px);
    const int s_lo = (lo + len - 1) / len, s_hi = min(splits, (hi + len - 1) / len);
    const int l = tid & 31, i = (l / 6) % 3, j = l % 6;
    for (int slice = s_lo + tid / 32; slice < s_hi; slice += kGemmWarps) {
      const int k1 = min((slice + 1) * len, m);
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int k = slice * len; k < k1;) {
        const int owner = k / cta_px;
        const int end = min(k1, (owner + 1) * cta_px);
        const float* tw = owner == rank ? tile_w : cluster.map_shared_rank(tile_w, owner);
        const float* tj = tw + 6 * kTilePx;
        const int off = owner * cta_px;
#pragma unroll 8
        for (; k < end; ++k) {
          const int e = 6 * (k - off);
          const float jj = tj[e + j];
          acc0 = fmaf(tw[e + i], jj, acc0);
          acc1 = fmaf(tw[e + i + 3], jj, acc1);
        }
      }
      if (l < 18) {
        partials[36 * slice + 6 * i + j] = acc0;
        partials[36 * slice + 6 * (i + 3) + j] = acc1;
      }
    }
  }
  cluster_barrier(cluster);
  if (rank != 0) return;

  // CTA 0: the cost, best-cost rollback, and the damped system (or the outputs).
  reduce_tree(lane_out + kWrr * kLanes, lane_out + kWf * kLanes, m, sh);
  if (!last) {
    // The slices' partials, added in slice order (cuBLAS's split-K reduce).
    float* part = wins;
    for (int e = tid; e < 36 * splits; e += kThreads) part[e] = __ldcg(partials + e);
    __syncthreads();
    if (tid < 36) {
      float h = part[tid];
#pragma unroll 8
      for (int s = 1; s < splits; ++s) h = add(h, part[36 * s + tid]);
      sh.H[tid] = h;
    }
    __syncthreads();
  }
  if (tid == 0) {
    float n_ok = 0.0f;
    for (int c = 0; c < ctas; ++c) n_ok += __ldcg(counts + c);
    const float mean = __fdiv_rn(sh.sum[0], clamp_lo(sh.sum[1], 1.0f));
    const float cost = n_ok >= 10.0f ? mean : INFINITY;
    float best_R[9], best_t[3], best_cost;
    if (a.step == 0) {
      for (int k = 0; k < 9; ++k) best_R[k] = __ldg(a.R0 + k);
      for (int k = 0; k < 3; ++k) best_t[k] = __ldg(a.t0 + k);
      best_cost = INFINITY;
    } else {
      for (int k = 0; k < 9; ++k) best_R[k] = __ldcg(a.state + kBestR + k);
      for (int k = 0; k < 3; ++k) best_t[k] = __ldcg(a.state + kBestT + k);
      best_cost = __ldcg(a.state + kBestCost);
    }
    if (cost < best_cost) {
      for (int k = 0; k < 9; ++k) best_R[k] = sh.R[k];
      for (int k = 0; k < 3; ++k) best_t[k] = sh.t[k];
    }
    best_cost = isnan(cost) || isnan(best_cost) ? NAN : fminf(cost, best_cost);   // torch.minimum
    if (last) {
      for (int k = 0; k < 9; ++k) a.R_out[k] = best_R[k];
      for (int k = 0; k < 3; ++k) a.t_out[k] = best_t[k];
      *a.cost_out = best_cost;
    } else {
      for (int k = 0; k < 9; ++k) a.state[kR + k] = sh.R[k];
      for (int k = 0; k < 3; ++k) a.state[kT + k] = sh.t[k];
      for (int k = 0; k < 9; ++k) a.state[kBestR + k] = best_R[k];
      for (int k = 0; k < 3; ++k) a.state[kBestT + k] = best_t[k];
      a.state[kBestCost] = best_cost;
      const float* H = sh.H;
      const float trace = add(add(add(H[0], H[28]), H[14]), add(add(H[7], H[35]), H[21]));
      const float damp = add(mul(trace, 1.0f / 6.0f), 1.0f);
      for (int i = 0; i < 6; ++i) {
        for (int j = 0; j < 6; ++j) {
          const float lm = i == j ? mul(a.lm_damping, 1.0f) : mul(a.lm_damping, 0.0f);
          a.state[kHd + 6 * i + j] = add(H[6 * i + j], mul(lm, damp));
        }
      }
    }
  }
}

// The cluster (a power of two, at most 16 CTAs) for n points.
int cluster_size(int n) {
  int c = 1;
  while (c * kMaxPoints < n) c *= 2;
  return c;
}

cudaLaunchConfig_t launch_config(int n, int win, cudaLaunchAttribute* attr, int* per_cta) {
  const int ctas = cluster_size(n);
  *per_cta = (n + ctas - 1) / ctas;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kMaxDynamicSmem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per device: room for the largest windows, and 16-CTA clusters.
cudaError_t configure() {
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (configured & (1u << dev))) return cudaSuccess;
  err = cudaFuncSetAttribute(direct_gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxDynamicSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(direct_gn_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err == cudaSuccess && dev < 32) configured |= 1u << dev;
  return err;
}

}  // namespace

// Floats of state and of scratch one level pass of n points needs.
extern "C" int viso_direct_gn_state_floats() { return kStateFloats; }
extern "C" int64_t viso_direct_gn_scratch_floats(int n) {
  return static_cast<int64_t>(kArrays) * n * kPatchPx + kSplits * 36 + kArrays * kLanes +
         kMaxCluster;
}

// Step `step` (0..iters) of one level's GN: step > 0 first solves with the
// previous step's Jr = J6w @ rf and updates the pose; every step but the
// last writes J6w, rf and the damped system into state; the last writes
// R_out (3, 3), t_out (3,) and cost_out (). Returns a CUDA error code
// (cudaErrorInvalidValue for shapes the design does not take: fewer than
// 2 or more than 1,024 points, a window over 24 or under 2).
extern "C" int viso_direct_gn(
    const float* windows, const int* base, const float* T, const float* J6,
    const unsigned char* ref_ok, const float* d_ref, const float* points,
    const float* R0, const float* t0, const float* Jr, float* state, float* scratch,
    float* J6w, float* rf, int n, int win, int height, int width, int iters, int affine,
    int step, float fx, float fy, float cx, float cy, float min_depth, float huber,
    float lm_damping, float scale_hi, float* R_out, float* t_out, float* cost_out,
    void* stream) {
  if (n < 2 || n > kMaxCluster * kMaxPoints || win < 2 || win > kMaxWin || iters < 0 ||
      step < 0 || step > iters) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  int per_cta = 0;
  cudaLaunchConfig_t cfg = launch_config(n, win, attr, &per_cta);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const Args args{windows, base, T, J6, ref_ok, d_ref, points, R0, t0, Jr, state, scratch,
                  J6w, rf, R_out, t_out, cost_out, n, win, height, width, iters, affine,
                  per_cta, step, fx, fy, cx, cy, min_depth, huber, lm_damping, scale_hi};
  err = cudaLaunchKernelEx(&cfg, direct_gn_kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// An empty kernel: the card's launch floor, timed beside the pass.
extern "C" int viso_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
