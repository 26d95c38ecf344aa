// K9: the (k_perp, pi) bin sums of an rfft-mesh weight.
//
// Replaces abacusutils_tpu/ops/power.py:_bin_kppi_sums (via bin_kppi). For
// every mode (ix, iy, kz) of an (n1d, n1d, n1d/2+1) mesh, k_perp^2 = ix^2 +
// iy^2 picks the k_perp bin of the row (ix, iy) and kz^2 the pi bin; the bin
// gains dup * w, dup = 1 on kz = 0 and on the Nyquist plane of an even mesh,
// else 2. On the TPU these were two one-hot (rows x Nk, kz x Npi) matmuls at
// HIGHEST precision, standing in for a scatter.
//
// The bins are separable, and the host plan (ops/power.py:kppi_plan) holds
// the separation: the rows of each k_perp bin, sorted by bin and cut into
// items of at most kItemRows rows of one bin, and the contiguous kz range of
// each pi bin (k_z^2 rises along a row). A block takes one item: its thread
// t sums the column kz = t (t + blockDim, ...) over the item's rows in f64,
// neighbouring threads on neighbouring floats of a row, then applies the
// column's dup and parks the column sum in shared memory; the block then
// adds each pi bin's kz range in kz order and writes one (Npi,) f64 partial.
// A second kernel adds each k_perp bin's partials in item order. No atomics:
// two launches give the same bits. The counts are exact integers from the
// plan and are not computed here.
//
// What bounds it on the H100: the bytes of the in-bin weights, each read
// once (4 B a mode, 0.27 GB at 512^3 against 2 x 8 B of f64 sums a bin);
// the arithmetic is one f64 add a mode. Eight independent loads a thread
// are in flight before their adds, and an item's rows are enough blocks
// (n1d^2 / 32 at most) to fill the card.

#include <cuda_runtime.h>

namespace {

constexpr int kItemRows = 32;  // ops/power.py KPPI_ITEM_ROWS
constexpr int kUnroll = 8;

__global__ void kppi_rows_kernel(const float* __restrict__ w, long long sx, long long sy,
                                 int n1d, int kzv, int nyq, const int* __restrict__ rows,
                                 const int* __restrict__ items, const int* __restrict__ zstart,
                                 int npi, double* __restrict__ partials) {
    extern __shared__ double col[];  // kzv column sums
    __shared__ long long off[kItemRows];
    const int it = blockIdx.x;
    const int r0 = items[2 * it];
    const int nr = items[2 * it + 1] - r0;
    for (int i = threadIdx.x; i < nr; i += blockDim.x) {
        const int r = rows[r0 + i];
        off[i] = (long long)(r / n1d) * sx + (long long)(r % n1d) * sy;
    }
    __syncthreads();
    for (int kz = threadIdx.x; kz < kzv; kz += blockDim.x) {
        double s = 0.0;
        int i = 0;
        for (; i + kUnroll <= nr; i += kUnroll) {
            float v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(w + off[i + u] + kz);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) s += (double)v[u];
        }
        for (; i < nr; ++i) s += (double)__ldg(w + off[i] + kz);
        col[kz] = (kz == 0 || kz == nyq) ? s : 2.0 * s;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < npi; p += blockDim.x) {
        double s = 0.0;
        for (int kz = zstart[p]; kz < zstart[p + 1]; ++kz) s += col[kz];
        partials[(size_t)it * npi + p] = s;
    }
}

// out[b][p] = the sum of partials[it][p] over the items it of k_perp bin b,
// in item order
__global__ void kppi_reduce_kernel(const double* __restrict__ partials,
                                   const int* __restrict__ item_start, int nk, int npi,
                                   double* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nk * npi) return;
    const int b = i / npi, p = i % npi;
    double s = 0.0;
    for (int it = item_start[b]; it < item_start[b + 1]; ++it) s += partials[(size_t)it * npi + p];
    out[i] = s;
}

}  // namespace

// w: the f32 weights, element (ix, iy, kz) at ix * sx + iy * sy + kz; kzv:
// the kz in a pi bin (a prefix of the row); nyq: the kz of dup 1 besides 0
// (-1: none); rows, items (nitems x [begin, end)), item_start (nk + 1),
// zstart (npi + 1): the plan; threads: a block's threads (a multiple of 32);
// partials: max(nitems, 1) * npi doubles of scratch; out: nk * npi doubles.
extern "C" int kppi_bin(const float* w, long long sx, long long sy, int n1d, int kzv, int nyq,
                        const int* rows, const int* items, int nitems, const int* item_start,
                        const int* zstart, int nk, int npi, int threads, double* partials,
                        double* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int smem = kzv * (int)sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(kppi_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (nitems > 0) {
        kppi_rows_kernel<<<nitems, threads, smem, s>>>(w, sx, sy, n1d, kzv, nyq, rows, items,
                                                        zstart, npi, partials);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const int n = nk * npi;
    kppi_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partials, item_start, nk, npi, out);
    return (int)cudaGetLastError();
}
