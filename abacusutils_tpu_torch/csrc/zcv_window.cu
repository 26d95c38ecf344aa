// K8: the ZCV window's per-bin mode sums over an rfft mesh.
//
// Replaces abacusutils_tpu/models/zcv/zenbu_window.py:_window_sums_impl (jit
// via _window_mode_sums_device): for every rfft mode (ix, iy, iz) of an
// nmesh^3 mesh, |k| = sqrt(kx^2 + ky^2 + kz^2) in f32 picks an output bin by
// the f32 thresholds of zenbu_window.py:_f32_ge_edges (bin b holds the modes
// with e[b] <= |k| < e[b+1]; a mode outside every bin adds nothing), and the
// bin gains seven f32 weights:
//
//   dup, dup |k|, dup L2, dup L4, dup L2 L2, dup L2 L4, dup L4 L4
//
// with mu = kz / |k| (0 at |k| = 0), L2 = (3 mu mu - 1) / 2 and L4 = (35 mu^4
// - 30 mu mu + 3) / 8 in the JAX program's association (mu^4 = (mu mu)(mu
// mu)), and dup = 2 for every kz > 0, the Nyquist plane included (the
// window's own rule, zenbu_window.py:102-104; not ops/power.py's mode_dup).
// Every f32 step is an _rn intrinsic, so nvcc contracts nothing into an FMA.
//
// On the TPU this was a one-hot (M, nkout) matrix per kx plane contracted on
// the MXU. Here a warp takes a row (ix, iy) of the mesh, 32 consecutive kz
// at a time. Along a row |k| grows with kz (each correctly rounded step is
// monotone), so the bins of the 32 lanes are non-decreasing: a segmented
// inclusive scan by shuffles (fixed order, in f64) gives the sum of each run
// of equal bins at its last lane, which adds it into the warp's own f64
// histogram in shared memory with a plain add (the runs of a chunk hold
// distinct bins). After its rows, the block sums its warps' histograms in
// warp order and writes one (7, nkout) f64 partial; a second kernel sums the
// partials in block order. No atomics anywhere, so repeated calls give the
// same bits, and the counts row (sums of 1 and 2) is exact.
//
// What bounds it on the H100: the bytes are negligible (two k tables in,
// 7 x nkout sums out); the f32 arithmetic of each mode (about 25 operations
// with a square root and a division) and the scan's shuffles bound it. A
// block takes a group of rows of one plane, so nmesh x groups blocks fill
// the card, and the histograms cost 56 B a bin a warp of shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 7;  // the weight rows

__global__ void zcv_window_sums_kernel(const float* __restrict__ kv,
                                       const float* __restrict__ kzv,
                                       const float* __restrict__ edges, int nmesh, int nkout,
                                       int rows_per_group, double* __restrict__ partials) {
    extern __shared__ double smem[];
    const int warps = blockDim.x / 32;
    double* hist = smem;  // [warp][row][bin]
    float* e = reinterpret_cast<float*>(smem + (size_t)warps * ROWS * nkout);
    for (int i = threadIdx.x; i < warps * ROWS * nkout; i += blockDim.x) hist[i] = 0.0;
    for (int i = threadIdx.x; i <= nkout; i += blockDim.x) e[i] = edges[i];
    __syncthreads();

    const int ix = blockIdx.x;
    const int nz = nmesh / 2 + 1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    double* h = hist + (size_t)warp * ROWS * nkout;
    const float kx = kv[ix];
    const float kx2 = __fmul_rn(kx, kx);
    const int y0 = blockIdx.y * rows_per_group;
    const int y1 = min(y0 + rows_per_group, nmesh);
    for (int iy = y0 + warp; iy < y1; iy += warps) {
        const float ky = kv[iy];
        const float kxy2 = __fadd_rn(kx2, __fmul_rn(ky, ky));
        for (int c0 = 0; c0 < nz; c0 += 32) {
            const int iz = c0 + lane;
            // bin key: -1 below the first edge, nkout at or past the last,
            // nkout + 1 past the row's end; non-decreasing across the lanes
            int key = nkout + 1;
            double v[ROWS] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
            if (iz < nz) {
                const float kz = kzv[iz];
                const float knorm = __fsqrt_rn(__fadd_rn(kxy2, __fmul_rn(kz, kz)));
                // upper bound: the number of thresholds <= knorm
                int lo = 0, hi = nkout + 1;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (e[mid] <= knorm) lo = mid + 1; else hi = mid;
                }
                key = lo - 1;
                if (key >= 0 && key < nkout) {
                    const float mu = knorm > 0.f ? __fdiv_rn(kz, knorm) : 0.f;
                    const float t2 = __fmul_rn(__fmul_rn(3.f, mu), mu);
                    const float L2 = __fdiv_rn(__fsub_rn(t2, 1.f), 2.f);
                    const float m2 = __fmul_rn(mu, mu);
                    const float m4 = __fmul_rn(m2, m2);
                    const float t = __fsub_rn(__fmul_rn(35.f, m4),
                                              __fmul_rn(__fmul_rn(30.f, mu), mu));
                    const float L4 = __fdiv_rn(__fadd_rn(t, 3.f), 8.f);
                    const float dup = kz > 0.f ? 2.f : 1.f;
                    const float dL2 = __fmul_rn(dup, L2);
                    const float dL4 = __fmul_rn(dup, L4);
                    v[0] = dup;
                    v[1] = __fmul_rn(dup, knorm);
                    v[2] = dL2;
                    v[3] = dL4;
                    v[4] = __fmul_rn(dL2, L2);
                    v[5] = __fmul_rn(dL2, L4);
                    v[6] = __fmul_rn(dL4, L4);
                } else if (key >= nkout) {
                    key = nkout;
                }
            }
            // segmented inclusive scan over runs of equal keys
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int kup = __shfl_up_sync(0xffffffffu, key, off);
                const bool add = lane >= off && kup == key;
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const double up = __shfl_up_sync(0xffffffffu, v[r], off);
                    if (add) v[r] += up;
                }
            }
            const int knext = __shfl_down_sync(0xffffffffu, key, 1);
            const bool last = lane == 31 || knext != key;
            if (last && key >= 0 && key < nkout) {
#pragma unroll
                for (int r = 0; r < ROWS; ++r) h[r * nkout + key] += v[r];
            }
            __syncwarp();
        }
    }
    __syncthreads();
    double* out = partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ROWS * nkout;
    for (int i = threadIdx.x; i < ROWS * nkout; i += blockDim.x) {
        double s = 0.0;
        for (int w = 0; w < warps; ++w) s += hist[(size_t)w * ROWS * nkout + i];
        out[i] = s;
    }
}

// out[i] = sum of partials[b][i] over the blocks b in order
__global__ void zcv_window_reduce_kernel(const double* __restrict__ partials, int nblocks, int n,
                                         double* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    double s = 0.0;
    for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * n + i];
    out[i] = s;
}

}  // namespace

// kv: (nmesh,) f32 k of the mesh axes; kzv: (nmesh / 2 + 1,) f32 k of the
// rfft axis; edges: (nkout + 1,) f32 thresholds; groups: row groups a plane;
// warps: warps a block; smem: shared bytes (warps * 7 * nkout doubles and the
// nkout + 1 thresholds); partials: nmesh * groups * 7 * nkout doubles of
// scratch; out: 7 * nkout doubles.
extern "C" int zcv_window_sums(const float* kv, const float* kzv, const float* edges, int nmesh,
                               int nkout, int groups, int warps, int smem, double* partials,
                               double* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaFuncSetAttribute(zcv_window_sums_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int rows_per_group = (nmesh + groups - 1) / groups;
    zcv_window_sums_kernel<<<dim3(nmesh, groups), 32 * warps, smem, s>>>(
        kv, kzv, edges, nmesh, nkout, rows_per_group, partials);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int n = ROWS * nkout;
    zcv_window_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partials, nmesh * groups, n, out);
    return (int)cudaGetLastError();
}
