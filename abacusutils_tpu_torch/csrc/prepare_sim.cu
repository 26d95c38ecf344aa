// K6 and K7: the two device engines of prepare_sim, in float64.
//
// K6 nn_within_halo: for every query particle (a selected particle of a
// ranked halo), the least squared distance to any other particle (other by
// index) of its halo's window [pstart, pstart + pnum), selected or not, with
// the coordinates cast from float32 to float64. Replaces the TPU programs
// abacusutils_tpu/models/hod/ranks_device.py:_nn_small_vec (halos of at most
// 64 particles packed into an (nrows, capG) layout and reduced as
// (cblock, capG, capG) tiles) and :_nn_class_scan (bigger halos in power-of-
// two capacity classes, one dynamic slice a halo), reached through
// ranks_device.py:_nn_keys. Those shapes fed the TPU's vector unit; here the
// queries are grouped by halo (ops/grid.py:work_items, at most K6_THREADS
// queries an item), each block takes one item, streams its halo's window
// through shared-memory tiles of float64 x, y, z, and each thread keeps its
// query's minimum in a register.
//
// K7 menv_annulus: for each centre i whose mass exceeds mcut,
//   Menv[i] = sum_j m_j ([d2 <= r_out^2] - [d2 <= r_in,i^2]),
// both balls closed (the self term cancels), d the periodic minimum image
// dx - L rint(dx / L) in a box (rint rounds half to even, as jnp.round) and
// the plain difference in a light cone; every other centre gets 0. Replaces
// abacusutils_tpu/models/hod/menv_device.py:_menv_vec (cells packed into a
// global-capacity (rows, 4 capG) layout, all cells against each of the 27
// neighbour rows as (cblock, capG, capG) tiles), :_menv_class (per-cell
// dynamic slices in (row, window) capacity classes) and the layouts of
// :_menv_vec_layouts. Here the halos are sorted by cell once; a block takes
// at most K7_THREADS centres of one cell, finds its 27 neighbour cells from
// the per-axis neighbour tables (wrapped and deduplicated for periodic axes,
// -1 for the open faces of a light cone) and the cell starts, and streams
// each neighbour cell through shared memory in a fixed order. One thread a
// centre sums in a float64 register, with no atomics: the result is the same
// on every run.
//
// Arithmetic: every product, quotient and sum is written with the _rn
// intrinsics, so nvcc cannot contract a product and a sum into an FMA. The
// squared distance is (dx dx + dy dy) + dz dz, the association of the host
// cKDTree and of the JAX package, so the NN keys equal the host loop's f64
// distances bit for bit and K7 classifies each pair as the tree does.
//
// What bounds them on the H100: float64 operations. K6 does 8 a pair
// (3 differences, 3 products, 2 sums) over sum of (queries x window) pairs;
// K7 9 a candidate (3 differences, 3 products, 2 sums and the compare; the
// box's minimum image adds a quotient, a round, a product and a difference
// an axis) over the candidates of the 27-cell walk. The bytes they read are
// a few per pair from shared memory and 12 or 40 a point from device
// memory. The H100's f64 rate outside the tensor cores is 34 TFLOP/s, half
// the f32 rate, so the design keeps each pair's work to those operations and
// a register compare; it makes no attempt yet to keep more lanes busy on
// small halos (a 20-particle halo fills 14 of a block's 128 threads).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K6_THREADS = 128;  // queries of a work item
constexpr int K6_TILE = 256;     // window particles a shared tile holds
constexpr int K7_THREADS = 64;   // centres of a work item
constexpr int K7_TILE = 64;      // neighbour halos a shared tile holds

__device__ __forceinline__ double sq3(double dx, double dy, double dz) {
    return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
}

__global__ void __launch_bounds__(K6_THREADS)
nn_within_halo_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ z, const int* __restrict__ query,
                      const int* __restrict__ work, const int* __restrict__ pstart,
                      const int* __restrict__ pnum, double* __restrict__ nn_d2) {
    __shared__ double sx[K6_TILE], sy[K6_TILE], sz[K6_TILE];
    const int halo = work[3 * blockIdx.x];
    const int begin = work[3 * blockIdx.x + 1];
    const int end = work[3 * blockIdx.x + 2];
    if (begin >= end) return;  // uniform across the block
    const int w0 = pstart[halo];
    const int wn = pnum[halo];
    const int q = begin + threadIdx.x;
    const bool active = q < end;
    const int qi = active ? query[q] : -1;
    double qx = 0.0, qy = 0.0, qz = 0.0;
    if (active) {
        qx = (double)x[qi];
        qy = (double)y[qi];
        qz = (double)z[qi];
    }
    double best = CUDART_INF;
    for (int t0 = 0; t0 < wn; t0 += K6_TILE) {
        const int nt = min(K6_TILE, wn - t0);
        __syncthreads();  // the previous tile is consumed
        for (int k = threadIdx.x; k < nt; k += K6_THREADS) {
            sx[k] = (double)x[w0 + t0 + k];
            sy[k] = (double)y[w0 + t0 + k];
            sz[k] = (double)z[w0 + t0 + k];
        }
        __syncthreads();
        if (!active) continue;
        const int self = qi - w0 - t0;  // the query's own slot in this tile, if any
        for (int k = 0; k < nt; ++k) {
            if (k == self) continue;
            const double d2 = sq3(__dsub_rn(qx, sx[k]), __dsub_rn(qy, sy[k]), __dsub_rn(qz, sz[k]));
            best = fmin(best, d2);
        }
    }
    if (active) nn_d2[qi] = best;
}

struct MenvGrid {
    long long nc0, nc1, nc2;  // cells along each axis
    int periodic;
    double lbox;
    double rout2;
    double mcut;
};

// the slot of raw cell id `wc` among the nu sorted occupied cells `ukeys`, or -1
__device__ __forceinline__ long long dense_slot(const long long* ukeys, int nu, long long wc) {
    int lo = 0, hi = nu;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ukeys[mid] < wc) lo = mid + 1;
        else hi = mid;
    }
    return (lo < nu && ukeys[lo] == wc) ? lo : -1;
}

__device__ __forceinline__ double min_image(double d, double lbox) {
    return __dsub_rn(d, __dmul_rn(lbox, rint(__ddiv_rn(d, lbox))));
}

__global__ void __launch_bounds__(K7_THREADS)
menv_annulus_kernel(const double* __restrict__ x, const double* __restrict__ y,
                    const double* __restrict__ z, const double* __restrict__ m,
                    const double* __restrict__ rin2, const int* __restrict__ starts,
                    const long long* __restrict__ ukeys, int nu, const int* __restrict__ nbr0,
                    const int* __restrict__ nbr1, const int* __restrict__ nbr2,
                    const int* __restrict__ work, MenvGrid g, double* __restrict__ out) {
    __shared__ double sx[K7_TILE], sy[K7_TILE], sz[K7_TILE], sm[K7_TILE];
    __shared__ int wstart[27], wlen[27];
    const int cell = work[3 * blockIdx.x];
    const int begin = work[3 * blockIdx.x + 1];
    const int end = work[3 * blockIdx.x + 2];
    if (begin >= end) return;  // uniform across the block

    if (threadIdx.x < 27) {
        const long long raw = ukeys ? ukeys[cell] : (long long)cell;
        const long long ci = raw / (g.nc1 * g.nc2);
        const long long cj = (raw / g.nc2) % g.nc1;
        const long long ck = raw % g.nc2;
        const int t = threadIdx.x;
        const int wi = nbr0[3 * ci + t / 9];
        const int wj = nbr1[3 * cj + (t / 3) % 3];
        const int wk = nbr2[3 * ck + t % 3];
        int s = 0, l = 0;
        if (wi >= 0 && wj >= 0 && wk >= 0) {
            const long long wc = ((long long)wi * g.nc1 + wj) * g.nc2 + wk;
            const long long slot = ukeys ? dense_slot(ukeys, nu, wc) : wc;
            if (slot >= 0) {
                s = starts[slot];
                l = starts[slot + 1] - s;
            }
        }
        wstart[t] = s;
        wlen[t] = l;
    }
    __syncthreads();

    const int i = begin + threadIdx.x;
    const bool active = i < end && m[i] > g.mcut;
    double xi = 0.0, yi = 0.0, zi = 0.0, ri2 = 0.0;
    if (active) {
        xi = x[i];
        yi = y[i];
        zi = z[i];
        ri2 = rin2[i];
    }
    double acc = 0.0;
    for (int w = 0; w < 27; ++w) {
        const int s = wstart[w];
        const int l = wlen[w];
        for (int t0 = 0; t0 < l; t0 += K7_TILE) {
            const int nt = min(K7_TILE, l - t0);
            __syncthreads();  // the previous tile is consumed
            for (int k = threadIdx.x; k < nt; k += K7_THREADS) {
                sx[k] = x[s + t0 + k];
                sy[k] = y[s + t0 + k];
                sz[k] = z[s + t0 + k];
                sm[k] = m[s + t0 + k];
            }
            __syncthreads();
            if (!active) continue;
            for (int k = 0; k < nt; ++k) {
                double dx = __dsub_rn(xi, sx[k]);
                double dy = __dsub_rn(yi, sy[k]);
                double dz = __dsub_rn(zi, sz[k]);
                if (g.periodic) {
                    dx = min_image(dx, g.lbox);
                    dy = min_image(dy, g.lbox);
                    dz = min_image(dz, g.lbox);
                }
                const double d2 = sq3(dx, dy, dz);
                const int ann = (d2 <= g.rout2) - (d2 <= ri2);
                if (ann > 0) acc = __dadd_rn(acc, sm[k]);
                else if (ann < 0) acc = __dsub_rn(acc, sm[k]);
            }
        }
    }
    if (i < end) out[i] = active ? acc : 0.0;
}

}  // namespace

// ---- host entries ----

// x, y, z: float32 particle columns; query: the particle index of each query,
// grouped by halo; work: (nitems, 3) int32 (halo, begin, end) into query;
// pstart, pnum: int32 halo windows; nn_d2: float64 out, written at the query
// particles only.
extern "C" int nn_within_halo(const float* x, const float* y, const float* z, const int* query,
                              const int* work, int nitems, const int* pstart, const int* pnum,
                              double* nn_d2, void* stream) {
    if (nitems <= 0) return (int)cudaSuccess;
    nn_within_halo_kernel<<<nitems, K6_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, z, query, work, pstart, pnum, nn_d2);
    return (int)cudaGetLastError();
}

// x, y, z, m, rin2: float64 columns sorted by cell; starts: int32 offsets of
// the cells (ncells + 1); ukeys: the raw id of each of the nu occupied cells
// when starts indexes them densely, else null (starts indexes raw ids);
// nbr0/1/2: (nc, 3) int32 neighbour tables, -1 for an absent neighbour;
// work: (nitems, 3) int32 (cell, begin, end); out: float64, in sorted order.
extern "C" int menv_annulus(const double* x, const double* y, const double* z, const double* m,
                            const double* rin2, const int* starts, const long long* ukeys, int nu,
                            const int* nbr0, const int* nbr1, const int* nbr2, long long nc0,
                            long long nc1, long long nc2, int periodic, double lbox, double rout2,
                            double mcut, const int* work, int nitems, double* out, void* stream) {
    if (nitems <= 0) return (int)cudaSuccess;
    const MenvGrid g{nc0, nc1, nc2, periodic, lbox, rout2, mcut};
    menv_annulus_kernel<<<nitems, K7_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, z, m, rin2, starts, ukeys, nu, nbr0, nbr1, nbr2, work, g, out);
    return (int)cudaGetLastError();
}
