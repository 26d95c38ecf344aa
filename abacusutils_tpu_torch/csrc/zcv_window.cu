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
// the MXU. Here the host side (zenbu_window.py:window_plan) hands over a row
// plan: the seven weights of a mode depend only on the f32 kxy2 = kx kx + ky
// ky of its row and on kz, so the rows that share kxy2's bits are one row
// with a multiplicity (27,665 distinct values among 512^2 rows), sorted by
// kxy2, each with its run izlo..izhi of in-bin kz (21,074 rows with such a
// run, 3,639,158 modes at 512^3 with 256 bins to k_Nyq, 18.5x fewer than the
// mesh's 6.7e7). A row's squared norm fadd(kxy2, kz2[iz]) rises with iz, so
// its modes in bin b are one run of kz, and only the rows with kxy2 below
// bin b's upper threshold reach the bin: a prefix of the sorted rows, whose
// length the plan holds (reach). A block takes a bin (blockIdx.y) and a
// chunk of item_rows rows of its prefix (blockIdx.x; a chunk past the
// prefix has nothing to do); a thread takes every blockDim-th row of it,
// finds the row's first kz in the bin by a binary search of its run, and
// walks kz up to the bin's upper threshold, summing the seven weights times
// the row's multiplicity (an exact f64 product) in f64 registers. Neighbouring lanes hold neighbouring kxy2, so their runs in
// one bin are alike in length. The block adds the threads' sums in a fixed
// tree (shuffles down within a warp, then the warps in order) into one (7,)
// partial; a second kernel adds each bin's chunk partials in chunk order,
// one thread an output. No atomics and no histograms: repeated calls give the
// same bits, and the counts row (sums of 1 and 2 times integer
// multiplicities) is exact.
//
// What bounds it on the H100: the arithmetic of the plan's in-bin modes,
// about 22 f32 operations with a root and a division, and seven f64
// products and sums (K8_PLAN_F64_OPS in chip_smoke.py), 1.5 us at 512^3 at
// the published f64 rate; the row and k tables it reads are 0.4 MB. The
// binary search and the empty chunks are this design's own cost, beside
// that work.
// The divisions by 2 and 8 of L2 and L4 are products by 0.5 and 0.125,
// which round the same exact value, so the weights keep their bits.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 7;  // the weight rows

// the seven f32 weights of a mode of squared norm ksq (fadd(kxy2, kz kz))
// and rfft k `kz` (see above)
__device__ __forceinline__ void mode_weights(float ksq, float kz, float v[ROWS]) {
    const float knorm = __fsqrt_rn(ksq);
    const float mu = knorm > 0.f ? __fdiv_rn(kz, knorm) : 0.f;
    const float t2 = __fmul_rn(__fmul_rn(3.f, mu), mu);
    const float L2 = __fmul_rn(__fsub_rn(t2, 1.f), 0.5f);
    const float m2 = __fmul_rn(mu, mu);
    const float m4 = __fmul_rn(m2, m2);
    const float t = __fsub_rn(__fmul_rn(35.f, m4), __fmul_rn(__fmul_rn(30.f, mu), mu));
    const float L4 = __fmul_rn(__fadd_rn(t, 3.f), 0.125f);
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
}

__global__ void zcv_window_rows_kernel(const int* __restrict__ reach, int item_rows,
                                       const float* __restrict__ kxy2,
                                       const double* __restrict__ mult,
                                       const int* __restrict__ izlo,
                                       const int* __restrict__ izhi,
                                       const float* __restrict__ kzv,
                                       const float* __restrict__ kz2,
                                       const float* __restrict__ thr,
                                       double* __restrict__ partials) {
    __shared__ double red[32][ROWS];
    const int bin = blockIdx.y;
    const int r0 = blockIdx.x * item_rows;
    const int r1 = min(r0 + item_rows, __ldg(reach + bin));
    if (r0 >= r1) return;  // uniform across the block
    const float tlo = __ldg(thr + bin), thi = __ldg(thr + bin + 1);
    double acc[ROWS] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
        const float k2 = __ldg(kxy2 + r);
        const int end = __ldg(izhi + r) + 1;
        // the row's first kz at or above the bin's lower threshold
        int lo = __ldg(izlo + r), hi = end;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__fadd_rn(k2, __ldg(kz2 + mid)) < tlo)
                lo = mid + 1;
            else
                hi = mid;
        }
        const double m = __ldg(mult + r);
        for (int iz = lo; iz < end; ++iz) {
            const float ksq = __fadd_rn(k2, __ldg(kz2 + iz));
            if (!(ksq < thi)) break;
            float v[ROWS];
            mode_weights(ksq, __ldg(kzv + iz), v);
            // v m is exact in f64 (24 bits times an integer below 2^29)
#pragma unroll
            for (int q = 0; q < ROWS; ++q) acc[q] = __fma_rn((double)v[q], m, acc[q]);
        }
    }
    // the block's sum: a fixed tree within each warp, then the warps in order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc[q] = __dadd_rn(acc[q], __shfl_down_sync(0xffffffffu, acc[q], off));
        if (lane == 0) red[warp][q] = acc[q];
    }
    __syncthreads();
    if (threadIdx.x < ROWS) {
        double s = 0.0;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s = __dadd_rn(s, red[w][threadIdx.x]);
        partials[((size_t)bin * gridDim.x + blockIdx.x) * ROWS + threadIdx.x] = s;
    }
}

// out[q][b] = the sum of bin b's chunk partials, in chunk order
__global__ void zcv_window_reduce_kernel(const double* __restrict__ partials,
                                         const int* __restrict__ reach, int item_rows,
                                         int nchunks, int nkout, double* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= ROWS * nkout) return;
    const int q = i / nkout, b = i % nkout;
    const int n = (reach[b] + item_rows - 1) / item_rows;
    double s = 0.0;
    for (int c = 0; c < n; ++c) s = __dadd_rn(s, partials[((size_t)b * nchunks + c) * ROWS + q]);
    out[i] = s;
}

}  // namespace

// reach: (nkout,) int32, the rows each bin reaches (a prefix of nrows);
// item_rows: rows a block takes; kxy2, mult, izlo, izhi: the nrows plan
// rows' f32 value, f64 multiplicity and int32 run of in-bin kz; kzv, kz2:
// f32 k of the rfft axis and its square; thr: (nkout + 1,) f32
// squared-norm thresholds of the edges; threads: a block's threads (a
// multiple of 32, at most 1,024); partials: max(nkout * ceil(nrows /
// item_rows), 1) * 7 doubles of scratch; out: 7 * nkout doubles.
extern "C" int zcv_window_rows(const int* reach, int nrows, int item_rows, const float* kxy2,
                               const double* mult, const int* izlo, const int* izhi,
                               const float* kzv, const float* kz2, const float* thr, int nkout,
                               int threads, double* partials, double* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (threads < 32 || threads > 1024 || threads % 32 || nkout < 0 || nkout > 65535 ||
        nrows < 0 || item_rows < 1)
        return (int)cudaErrorInvalidValue;
    const int nchunks = (nrows + item_rows - 1) / item_rows;
    if (nchunks > 0 && nkout > 0) {
        zcv_window_rows_kernel<<<dim3(nchunks, nkout), threads, 0, s>>>(
            reach, item_rows, kxy2, mult, izlo, izhi, kzv, kz2, thr, partials);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const int n = ROWS * nkout;
    if (n > 0)
        zcv_window_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partials, reach, item_rows,
                                                                 nchunks, nkout, out);
    return (int)cudaGetLastError();
}
