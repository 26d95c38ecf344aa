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
// through shared-memory tiles of float4 (x, y, z, pad) in float32, and each
// thread keeps its query's minimum in a register. A cheap float32 test
// (below) proves almost every candidate farther than the running minimum;
// only the rest, and one seed neighbour a query, take the exact float64
// chain, so the key is the minimum of the same float64 values as before.

// K7 menv_annulus: for each centre i whose mass exceeds mcut,
//   Menv[i] = sum_j m_j ([d2 <= r_out^2] - [d2 <= r_in,i^2])
// over the halos j of the 27 cells around i's (the JAX package's sum),
// both balls closed (the self term cancels), d the periodic minimum image
// dx - L rint(dx / L) in a box (rint rounds half to even, as jnp.round) and
// the plain difference in a light cone; every other centre gets 0. Replaces
// abacusutils_tpu/models/hod/menv_device.py:_menv_vec (cells packed into a
// global-capacity (rows, 4 capG) layout, all cells against each of the 27
// neighbour rows as (cblock, capG, capG) tiles), :_menv_class (per-cell
// dynamic slices in (row, window) capacity classes) and the layouts of
// :_menv_vec_layouts. Here the halos are sorted by cell once (cells of edge
// >= r_outer, so the 27 cells hold every ball of radius r_outer) and the
// centres are cut into work items (models/hod/menv_device.py:_row_runs): a
// run of occupied cells k0..k1 along z in one (i, j) row, up to the block's
// threads of centres. A block takes an item; its first warp finds the 9
// neighbour rows (i +- 1, j +- 1, wrapped and deduplicated for periodic
// axes of fewer than 3 cells, absent past an open face), each over cells
// k0 - 1 .. k1 + 1 cut at the periodic seam into at most 3 pieces: 27
// ranges, each contiguous in the sorted order (two cell starts, or in a
// light cone with dense ids two binary searches over them). The ranges are
// laid end to end and streamed through full shared tiles of x, y, z, m and
// the candidate's z cell; a candidate outside its centre's own 27 cells (a
// z cell more than one away) is skipped, so the sum is the 27-cell sum for
// any r_in. One thread a centre sums in a float64 register in the tiles'
// fixed order, with no atomics: the result is the same on every run.
//
// Where every axis has 5 cells or more, the minimum image of a candidate is
// its piece's wrap: rint(dx / L) is 0 within a row that did not wrap and
// +-1 across the seam (|dx| < 2 cells <= 0.4 L, or > 0.6 L), so dx - L
// rint(dx / L) is dx minus the piece's shift of 0 or +-L bit for bit, and
// the division goes (ROUND = false; a light cone has no shift). On a box of
// fewer cells the division stays (ROUND = true).
//
// Arithmetic: every product, quotient and sum is written with the _rn
// intrinsics, so nvcc cannot contract a product and a sum into an FMA. The
// squared distance is (dx dx + dy dy) + dz dz, the association of the host
// cKDTree and of the JAX package, so the NN keys equal the host loop's f64
// distances bit for bit and K7 classifies each pair as the tree does.
//
// What bounds them on the H100. K6: the pairs of sum (queries x window).
// Each costs 8 float64 operations on the exact chain (3 differences, 3
// products, 2 sums), and the filter's 9 float32 operations (3 differences, a
// product, 2 FMAs counted as 2 each, the compare) with one 16-byte shared
// load; the chain runs only for the candidates the filter keeps
// (chip_smoke.py phases 9 and 10 estimate their number on the ranks slabs
// with the filter's unfused plain mirror). K7: 9 float64 operations a
// candidate (3 differences, 3 products, 2 sums and the compare; the small
// box's minimum image adds a quotient, a round, a product and a difference
// an axis) over the candidates of the 27-cell walk. The bytes they read are
// a few per pair from shared memory and 12 or 40 a point from device
// memory. The H100's published float64 rate outside the tensor cores, 34
// TFLOP/s (67 in float32), counts an FMA as two operations; unfused _rn
// adds and products issue at half of it. K6's filter moves the pairs to the
// float32 pipe, twice as wide, with one shared load a pair. K6 makes no
// attempt to keep more lanes busy on small halos (a 20-particle halo fills
// 14 of a block's 128 threads): they hold a small share of the pairs. K7's
// items gather the centres of a run of cells for that, but at 2e6 clumped
// halos they hold 5 centres on average (lane occupancy 0.16 in a box), so
// each item's chain of dependent loads (its first centre's cell, the 27
// ranges' starts, the first tile) sets K7's time, at about 0.02 of the
// operation bound; items of 64 or 128 centres, most lanes idle, were slower
// than a warp an item (scripts/torch/k1m_k7_compare.py).
//
// K6's filter. Write u = 2^-24 and v = 2^-53, D^2 = Dx^2 + Dy^2 + Dz^2 for
// the exact real differences of a query and a candidate (float32 values,
// so exact reals), and K for the exact chain's key
// ((dx dx + dy dy) + dz dz, every step _rn in float64, dx = fl64(Dx)).
// (1) K >= D^2 (1 - 5v): dx carries one rounding, its square one more, and
// the two sums one each, five factors (1 + e), |e| <= v, at most, and
// nothing underflows: a difference of two float32 values is a multiple of
// 2^-149, so its square is at least 2^-298, a normal double.
// (2) The filter computes dxf = fl32(qx - sx) (not exact when the signs
// differ or the magnitudes are more than 2x apart: relative error <= u; a
// subnormal difference of two float32 values is exact), then
// d2f = fma(dx, dx, fma(dy, dy, dz dz)). In round to nearest with gradual
// underflow (nvcc without fast math keeps subnormals, and the _rn
// intrinsics keep the association), each rounding is fl(x) = x (1 + d) + h,
// |d| <= u, |h| <= 2^-150, and h = 0 unless the result is subnormal. The
// product dz dz and the two FMAs round once each, so
//   d2f <= D^2 (1 + u)^5 + 2^-150 ((1 + u)^2 + (1 + u) + 1)
//       <= D^2 (1 + 5.0001 u) + 2^-148.
// The unfused chain ((dx dx + (dy dy + dz dz))) obeys the same bound:
// three products may underflow, and a sum whose result is subnormal is
// exact (both terms are multiples of 2^-149).
// (3) So if d2f > T with T >= best (1 + 8u) + 2^-148, then D^2 (1 + 5.0001 u)
// > best (1 + 8u), D^2 > best (1 + 2.9u), and K >= D^2 (1 - 5v) > best: the
// candidate cannot lower the minimum, nor tie it. In the form
// d2f (1 - c u) - a > best, c = 8 and a = 2^-148 imply the same. T is
// best (1 + 2^-21) + 2^-148 in float64 rounded up, then rounded up to
// float32 (k6_threshold), refreshed only when best changes. A candidate
// whose key equals the final minimum, or lies below the minimum at the time,
// always passes; d2f = 0 (a duplicate, or a difference that underflows)
// always passes, since T >= 2^-148 > 0; NaN never compares greater, so it
// passes and the exact chain ignores it (fmin), as before.
// The running minimum starts from one neighbour of the window (the slot
// after the query's in the first tile, wrapped within it), so the filter
// works from the first candidate on. The filter tests a group of K6_GROUP
// candidates against the threshold at the group's start (a larger minimum
// only keeps more) and branches once for the group; the kept ones take the
// chain in order. The minimum of the same float64 values in any order is
// the same value, so the keys are bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K6_THREADS = 128;  // queries of a work item
constexpr int K6_TILE = 512;     // window particles a shared tile holds
constexpr int K6_GROUP = 8;      // candidates the filter tests before one branch

__device__ __forceinline__ double sq3(double dx, double dy, double dz) {
    return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
}

// the filter's float32 threshold for a running minimum `best` (see above):
// best (1 + 2^-21) + 2^-148, rounded up twice
__device__ __forceinline__ float k6_threshold(double best) {
    return __double2float_ru(__fma_ru(best, 1.0 + 0x1p-21, 0x1p-148));
}

// the filter's float32 squared distance of the query to a candidate
__device__ __forceinline__ float k6_d2f(float qx, float qy, float qz, float4 c) {
    const float dx = __fsub_rn(qx, c.x), dy = __fsub_rn(qy, c.y), dz = __fsub_rn(qz, c.z);
    return __fmaf_rn(dx, dx, __fmaf_rn(dy, dy, __fmul_rn(dz, dz)));
}

// the exact float64 chain for a candidate, folded into the running minimum
__device__ __forceinline__ void k6_exact(double qx, double qy, double qz, float4 c, double& best,
                                         float& thr) {
    const double d2 = sq3(__dsub_rn(qx, (double)c.x), __dsub_rn(qy, (double)c.y),
                          __dsub_rn(qz, (double)c.z));
    const double nb = fmin(best, d2);
    if (nb != best) {
        best = nb;
        thr = k6_threshold(best);
    }
}

__global__ void __launch_bounds__(K6_THREADS)
nn_within_halo_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ z, const int* __restrict__ query,
                      const int* __restrict__ work, const int* __restrict__ pstart,
                      const int* __restrict__ pnum, double* __restrict__ nn_d2) {
    __shared__ float4 tile[K6_TILE];
    const int halo = work[3 * blockIdx.x];
    const int begin = work[3 * blockIdx.x + 1];
    const int end = work[3 * blockIdx.x + 2];
    if (begin >= end) return;  // uniform across the block
    const int w0 = pstart[halo];
    const int wn = pnum[halo];
    const int q = begin + threadIdx.x;
    const bool active = q < end;
    const int qi = active ? query[q] : -1;
    const int own = qi - w0;  // the query's slot in its window
    float qxf = 0.f, qyf = 0.f, qzf = 0.f;
    if (active) {
        qxf = x[qi];
        qyf = y[qi];
        qzf = z[qi];
    }
    const double qx = qxf, qy = qyf, qz = qzf;
    double best = CUDART_INF;
    float thr = CUDART_INF_F;
    for (int t0 = 0; t0 < wn; t0 += K6_TILE) {
        const int nt = min(K6_TILE, wn - t0);
        __syncthreads();  // the previous tile is consumed
        for (int k = threadIdx.x; k < nt; k += K6_THREADS) {
            const int j = w0 + t0 + k;
            tile[k] = make_float4(x[j], y[j], z[j], 0.f);
        }
        __syncthreads();
        if (!active) continue;
        if (t0 == 0 && nt > 1) {
            // the seed: the next slot of the first tile, wrapped within it
            // (never the query's own slot)
            k6_exact(qx, qy, qz, tile[(own + 1) % nt], best, thr);
        }
        const int self = own - t0;  // the query's own slot in this tile, if any
        const int nfull = nt & ~(K6_GROUP - 1);
        for (int k0 = 0; k0 < nfull; k0 += K6_GROUP) {
            // the group's candidates against the threshold at its start (a
            // larger minimum only keeps more of them), then one branch
            unsigned keep = 0;
#pragma unroll
            for (int u = 0; u < K6_GROUP; ++u) {
                keep |= (k6_d2f(qxf, qyf, qzf, tile[k0 + u]) > thr ? 0u : 1u) << u;
            }
            if ((unsigned)(self - k0) < (unsigned)K6_GROUP) keep &= ~(1u << (self - k0));
            while (keep) {
                const int u = __ffs(keep) - 1;
                keep &= keep - 1;
                k6_exact(qx, qy, qz, tile[k0 + u], best, thr);
            }
        }
        for (int k = nfull; k < nt; ++k) {
            const float4 c = tile[k];
            if (k6_d2f(qxf, qyf, qzf, c) > thr || k == self) continue;
            k6_exact(qx, qy, qz, c, best, thr);
        }
    }
    if (active) nn_d2[qi] = best;
}

constexpr int K7_MAX_THREADS = 128;  // centres a work item may hold
constexpr int K7_TILE = 256;         // candidates a shared tile holds
constexpr int K7_SLOTS = 27;         // 9 neighbour rows x 3 pieces along z

struct MenvGrid {
    int nc0, nc1, nc2;  // cells along each axis
    int periodic;
    double lbox;
    double rout2;
};

// the first of the nu sorted occupied cells `ukeys` at or above raw id wc
__device__ __forceinline__ int lower_slot(const long long* ukeys, int nu, long long wc) {
    int lo = 0, hi = nu;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ukeys[mid] < wc) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ double min_image(double d, double lbox) {
    return __dsub_rn(d, __dmul_rn(lbox, rint(__ddiv_rn(d, lbox))));
}

// The neighbour of cell c at offset d (-1, 0, 1) on an axis of n cells
// (.x, -1 where there is none) and its wrap (.y: the neighbour's image lies
// .y * L away from the cell): wrapped on a periodic axis, where fewer than 3
// cells alias the offsets and only the distinct ones are kept
// (abacusutils_tpu/models/hod/menv_device.py:_axis_neighbors), absent past
// an open face.
__device__ __forceinline__ int2 neighbour(int c, int d, int n, bool periodic) {
    const int m = c + d;
    if (!periodic) return make_int2((m >= 0 && m < n) ? m : -1, 0);
    if (n < 3 && (n == 1 ? d != 0 : d < 0)) return make_int2(-1, 0);
    if (m < 0) return make_int2(m + n, -1);
    if (m >= n) return make_int2(m - n, 1);
    return make_int2(m, 0);
}

template <bool ROUND>
__global__ void __launch_bounds__(K7_MAX_THREADS)
menv_annulus_kernel(const double* __restrict__ x, const double* __restrict__ y,
                    const double* __restrict__ z, const double* __restrict__ m,
                    const double* __restrict__ rin2, const int* __restrict__ cells, int n,
                    const int* __restrict__ starts, const long long* __restrict__ ukeys, int nu,
                    const int* __restrict__ query, const int* __restrict__ work, MenvGrid g,
                    double* __restrict__ out) {
    __shared__ double tx[K7_TILE], ty[K7_TILE], tz[K7_TILE], tm[K7_TILE];
    __shared__ int tk[K7_TILE];      // the candidate's z cell
    __shared__ int tslot[K7_TILE];   // its range
    __shared__ int seg_cum[K7_SLOTS + 1];
    __shared__ int seg_sb[K7_SLOTS];
    __shared__ double3 seg_w[K7_SLOTS];
    const int qb = work[2 * blockIdx.x], qe = work[2 * blockIdx.x + 1];
    const int t = threadIdx.x;
    const int* ck = cells + 2 * (size_t)n;  // the z cells

    if (t < 32) {
        // the item's row and its first and last cell along z
        const int i0 = query[qb], i1 = query[qe - 1];
        const int ci = cells[i0], cj = cells[n + i0], k0 = ck[i0], k1 = ck[i1];
        const bool per = g.periodic != 0;
        int sb = 0, len = 0, wi = 0, wj = 0, wk = 0;
        if (t < K7_SLOTS) {
            const int r = t / 3, piece = t % 3;
            const int2 nbi = neighbour(ci, r / 3 - 1, g.nc0, per);
            const int2 nbj = neighbour(cj, r % 3 - 1, g.nc1, per);
            const int ni = nbi.x, nj = nbj.x;
            wi = nbi.y;
            wj = nbj.y;
            int ka = 0, kb = -1;
            if (per && g.nc2 < 3) {
                if (piece == 0) ka = 0, kb = g.nc2 - 1;  // the whole row, once
            } else if (piece == 0) {
                ka = max(k0 - 1, 0), kb = min(k1 + 1, g.nc2 - 1);
            } else if (piece == 1 && per && k0 == 0) {
                ka = kb = g.nc2 - 1, wk = -1;
            } else if (piece == 2 && per && k1 == g.nc2 - 1) {
                ka = kb = 0, wk = 1;
            }
            if (ni >= 0 && nj >= 0 && ka <= kb) {
                const long long base = ((long long)ni * g.nc1 + nj) * g.nc2;
                int lo, hi;
                if (ukeys) {
                    lo = lower_slot(ukeys, nu, base + ka);
                    hi = lower_slot(ukeys, nu, base + kb + 1);
                } else {
                    lo = (int)(base + ka);
                    hi = (int)(base + kb + 1);
                }
                sb = starts[lo];
                len = starts[hi] - sb;
            }
        }
        // exclusive prefix sum of the ranges' lengths
        int inc = len;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, inc, o);
            if (t >= o) inc += v;
        }
        if (t < K7_SLOTS) {
            seg_cum[t] = inc - len;
            seg_sb[t] = sb;
            seg_w[t] = make_double3(wi * g.lbox, wj * g.lbox, wk * g.lbox);
        }
        if (t == K7_SLOTS - 1) seg_cum[K7_SLOTS] = inc;
    }
    __syncthreads();
    const int total = seg_cum[K7_SLOTS];

    const bool active = t < qe - qb;
    const int i = active ? query[qb + t] : 0;
    double xi = 0.0, yi = 0.0, zi = 0.0, ri2 = 0.0;
    int ki = 0;
    if (active) {
        xi = x[i];
        yi = y[i];
        zi = z[i];
        ri2 = rin2[i];
        ki = ck[i];
    }
    double acc = 0.0;
    for (int p0 = 0; p0 < total; p0 += K7_TILE) {
        const int nt = min(K7_TILE, total - p0);
        __syncthreads();  // the previous tile is consumed
        int shifted = 0;
        for (int u = t; u < nt; u += blockDim.x) {
            const int pos = p0 + u;
            // the last range that begins at or before pos (an empty range
            // shares its begin with the next one)
            int lo = 0, hi = K7_SLOTS;
            while (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                if (seg_cum[mid] <= pos) lo = mid;
                else hi = mid;
            }
            const int j = seg_sb[lo] + (pos - seg_cum[lo]);
            tx[u] = x[j];
            ty[u] = y[j];
            tz[u] = z[j];
            tm[u] = m[j];
            tk[u] = ck[j];
            tslot[u] = lo;
            const double3 w = seg_w[lo];
            shifted |= (w.x != 0.0) | (w.y != 0.0) | (w.z != 0.0);
        }
        // tiles without a wrapped range (all but the items at the box's
        // faces, every tile of a light cone) subtract no shift
        const bool any_shift = __syncthreads_or(shifted) != 0;
        if (!active) continue;
        for (int k = 0; k < nt; ++k) {
            int dk = tk[k] - ki;
            if (g.periodic) {
                if (dk > 1) dk -= g.nc2;
                else if (dk < -1) dk += g.nc2;
            }
            if (dk < -1 || dk > 1) continue;  // outside the centre's 27 cells
            double dx = __dsub_rn(xi, tx[k]);
            double dy = __dsub_rn(yi, ty[k]);
            double dz = __dsub_rn(zi, tz[k]);
            if (ROUND) {
                dx = min_image(dx, g.lbox);
                dy = min_image(dy, g.lbox);
                dz = min_image(dz, g.lbox);
            } else if (any_shift) {
                const double3 w = seg_w[tslot[k]];
                dx = __dsub_rn(dx, w.x);
                dy = __dsub_rn(dy, w.y);
                dz = __dsub_rn(dz, w.z);
            }
            const double d2 = sq3(dx, dy, dz);
            const int ann = (d2 <= g.rout2) - (d2 <= ri2);
            if (ann > 0) acc = __dadd_rn(acc, tm[k]);
            else if (ann < 0) acc = __dsub_rn(acc, tm[k]);
        }
    }
    if (active) out[i] = acc;
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

// x, y, z, m, rin2: float64 columns sorted by cell; cells: (3, n) int32,
// each halo's cell along each axis; starts: int32 offsets of the cells
// (ncells + 1); ukeys: the raw id of each of the nu occupied cells when
// starts indexes them densely, else null (starts indexes raw ids); query:
// the int32 index of every centre above mcut, in sorted order; work:
// (nitems, 2) int32 (begin, end) into query, one run of cells of one row
// each, at most `threads` centres; round: 1 for the minimum image by
// division (a periodic grid of fewer than 5 cells an axis); out: float64, in
// sorted order, written at the centres only.
extern "C" int menv_annulus(const double* x, const double* y, const double* z, const double* m,
                            const double* rin2, const int* cells, int n, const int* starts,
                            const long long* ukeys, int nu, int nc0, int nc1, int nc2,
                            int periodic, double lbox, double rout2, const int* query,
                            const int* work, int nitems, int threads, int round, double* out,
                            void* stream) {
    if (nitems <= 0) return (int)cudaSuccess;
    if (threads < 32 || threads > K7_MAX_THREADS || threads % 32) return (int)cudaErrorInvalidValue;
    const MenvGrid g{nc0, nc1, nc2, periodic, lbox, rout2};
    const cudaStream_t s = (cudaStream_t)stream;
    if (round) {
        menv_annulus_kernel<true><<<nitems, threads, 0, s>>>(x, y, z, m, rin2, cells, n, starts,
                                                             ukeys, nu, query, work, g, out);
    } else {
        menv_annulus_kernel<false><<<nitems, threads, 0, s>>>(x, y, z, m, rin2, cells, n, starts,
                                                              ukeys, nu, query, work, g, out);
    }
    return (int)cudaGetLastError();
}
