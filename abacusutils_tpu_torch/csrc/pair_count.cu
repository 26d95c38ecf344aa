// K4 and K5: exact DD pair counts on a periodic box, in (rp, pi) or (s, mu) bins.
//
// Replace the TPU pair-count programs of abacusutils_tpu/ops/tpcf.py:
// K4 (pair_count_cells) stands for _combo_counts + _hist2d_cum, the cell-grid
// engine, and K5 (pair_count_all) for _count_rppi / _count_smu, the tiled
// all-pairs engine. On the TPU the histogram of a block of candidate pairs was
// a product of two cumulative one-hot matrices on the MXU, fed from padded
// power-of-two occupancy classes on a grid of cells of rmax a side. Nothing of
// that shape is kept: the counts are exact on any grid, so the grid, the work
// items and the walk are chosen for this card.
//
// What bounds both kernels on the H100: the instruction rate, not bytes. A
// candidate pair costs about a dozen f32 operations up to the reject test,
// and a pair in range a bin and a shared-memory add on top, which a warp
// pays for whenever one of its 32 candidates is in range: in a clustered
// catalog nearly always. Compares, selects and integer operations run at
// half the rate of f32 adds and products. So the design spends as few
// candidates a counted pair, and as few instructions a candidate and a bin, as
// it can:
//
// K4, one block a work item (ops/tpcf.py:stage_cells builds the stage):
//   1. Fewer candidates. The grid may be finer than rmax (cells of rmax / 2
//      where the catalogs are dense enough to fill them: a walk of at most
//      5 x 5 rows of cells), and the walk visits only the cells whose nearest
//      corner lies within the largest edge (and within pimax along z): `rows`
//      lists the (di, dj) rows of cells that survive with the reach Kd along z
//      of each.
//   2. A work item is at most 64 points of a run of consecutive cells of one
//      (ci, cj) row, which are consecutive in the sorted columns; its cells'
//      range k0..k1 is read from its first and last point. For each row of
//      the walk the cells k0 - Kd .. k1 + Kd of the neighbour row are one
//      contiguous range of points, cut only where it crosses a box face (up to
//      three pieces, each with its own wrap). The pieces of all rows are laid
//      end to end by a prefix sum in shared memory and streamed through a
//      256-entry tile that is full whatever the cells hold: one pair of
//      barriers a 256 candidates, not a neighbour cell. Sparse catalogs get
//      longer items, so several sparse cells share a block.
//   3. Each tile entry carries its point, its index and its row's
//      multiplicity, and beside it its piece's wrap shift (wx, wy, wz), so
//      pieces with different wraps share a tile. The second barrier of a tile
//      also tells whether any of its shifts is not 0; if none is (every item
//      away from the box faces) the block takes a copy of the pair loop that
//      neither loads nor subtracts them: x - 0 is x.
//   4. Register tiling: a thread holds up to 4 points of the item and
//      evaluates every tile entry it loads against all of them. The lanes
//      split TA x TB between the item's points (TA = the power of two >=
//      na / 4) and the tile, so a sparse item still fills its block. An empty
//      point slot holds NaN and fails every compare.
//   5. Binning: the bin along rp or s comes from a table over the leading bits
//      of r2 (Bins: a shift, two shared loads and one compare, whatever the
//      number of edges; an edge list too fine for the table takes one general
//      instance a mode that compares against every edge), the mu bin from an approximate reciprocal root that
//      is checked against its own error bound (mu_bin: the exact root and
//      quotient are taken only by the few pairs near a bin boundary), and each
//      warp adds to its own int32 histogram in shared memory with native
//      integer atomics; the block adds its non-zero bins to the int64 result
//      with atomicAdd(unsigned long long). Integer adds commute, so two
//      launches give the same bits.
//   An autocorrelation walks the centre row (di, dj) = (0, 0) in full, each
//   ordered pair once (i == j skipped by index in the instances for a first
//   edge of 0; above 0 it fails the reject test by itself), and the
//   lexicographically positive rows doubled.
//   The minimum image is the item-constant one, d = (p - q) - w * lbox with
//   the piece's w in {-1, 0, 1}; grids under 2 * reach + 3 cells a side take
//   the per-pair d - lbox * rint(d / lbox).
//
// K5, one block 512 rows of the first set (4 a thread) against a range of the
// second, streamed through a 128-entry tile: the same register tiling and
// binning on all pairs. Where both sets lie in one period (every |d| < 1.5
// lbox) rint(d / lbox) is -1, 0 or 1 and, division being monotone, equals
// (d > t) - (d < -t) for one threshold t that the host finds with the same
// rounded division: a compare, a sign copy and a subtraction, without a
// branch, replace a division and a round an axis. Other columns keep the
// division. float or double (the JAX tiled engine computes in double under
// x64).
//
// Every product, sum, difference, quotient and root that decides a pair's bin
// is an _rn intrinsic, so nvcc cannot contract a product and a sum into an FMA:
// dx*dx + dy*dy rounds as the JAX package's f32 program and a numpy brute
// force round it, and no pair changes its bin.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int K4_THREADS = 128;
constexpr int K4_TILE = 256;
constexpr int K4_POINTS = 4;
constexpr int K4_MAX_ROWS = 25;
constexpr int K4_SLOTS = 3 * K4_MAX_ROWS;
constexpr int K5_THREADS = 128;
constexpr int K5_POINTS = 4;
constexpr int K5_TILE = 128;
constexpr int MODE_RPPI = 0;
constexpr int MODE_SMU = 1;

template <typename T>
struct Ar;

template <>
struct Ar<float> {
    static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
    static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
    static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
    static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
    static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
    static __device__ __forceinline__ float rint(float a) { return rintf(a); }
    static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
    static __device__ __forceinline__ float nan() { return __int_as_float(0x7fc00000); }
};

template <>
struct Ar<double> {
    static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
    static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
    static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
    static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
    static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
    static __device__ __forceinline__ double rint(double a) { return ::rint(a); }
    static __device__ __forceinline__ double abs(double a) { return fabs(a); }
    static __device__ __forceinline__ double nan() {
        return __longlong_as_double(0x7ff8000000000000LL);
    }
};

// d - lbox * round(d / lbox), round half to even (abacusutils_tpu/ops/tpcf.py:_min_image)
template <typename T>
__device__ __forceinline__ T min_image(T d, T lbox) {
    return Ar<T>::sub(d, Ar<T>::mul(lbox, Ar<T>::rint(Ar<T>::div(d, lbox))));
}

// The same for |d| < 1.5 lbox, where the round is (d > t) - (d < -t) with t the
// largest value whose rounded quotient by lbox rounds to 0: d - lbox, d + lbox
// or d, each rounded once as d - lbox * w is.
template <typename T>
__device__ __forceinline__ T min_image_one_period(T d, T lbox, T t) {
    // without a branch: the shift is +-lbox or 0, and d - 0 is d
    const T shift = Ar<T>::abs(d) > t ? copysign(lbox, d) : (T)0;
    return Ar<T>::sub(d, shift);
}

__device__ __forceinline__ int high_bits(float a) { return __float_as_int(a); }
__device__ __forceinline__ int high_bits(double a) { return __double2hiint(a); }

// The first binning axis: the squared edges lo <= r2 < hi of all bins and the
// way to the bin of an r2 between them. LUT: a table over the leading bits of
// r2 (its exponent and as many mantissa bits as keep at most one inner edge a
// cell, every value below the first inner edge's cell in cell 0,
// ops/tpcf.py:bin_lut): the inner edges at or below the cell's lowest value,
// and the one edge inside the cell (+inf where there is none), so a bin costs
// a shift, two shared loads and one compare whatever the number of edges.
// Otherwise (an edge list too fine for a table of 2048 cells) a compare-sum
// over the edges in shared memory.
template <typename T, bool LUT>
struct Bins {
    T lo, hi;
    int shift, key0;
    const T* edge;    // LUT: the edge inside each cell; else the nb1 + 1 edges
    const int* base;  // LUT: the inner edges at or below each cell

    __device__ __forceinline__ int count(T r2, int nb1) const {
        if (LUT) {
            const int key = max((high_bits(r2) >> shift) - key0, 0);
            return base[key] + (r2 >= edge[key]);
        }
        int b = 0;
        for (int k = 1; k < nb1; ++k) b += r2 >= edge[k];
        return b;
    }
};

// Whether a pair with minimum-image differences dx, dy and adz = |dz| falls in
// a bin, and its r2 (rppi: dx^2 + dy^2, with adz < nb2; smu: plus adz^2). A NaN
// difference fails the compares and is outside.
template <typename T, int MODE, bool LUT>
__device__ __forceinline__ bool in_range(T dx, T dy, T adz, const Bins<T, LUT>& e, T nb2f,
                                         T* r2) {
    typedef Ar<T> A;
    T r = A::add(A::mul(dx, dx), A::mul(dy, dy));
    bool ok = true;
    if (MODE == MODE_RPPI) {
        ok = adz < nb2f;
    } else {
        r = A::add(r, A::mul(adz, adz));
    }
    *r2 = r;
    return ok && r >= e.lo && r < e.hi;
}

// int(mu * aux) with mu = adz / s and s = sqrt(r2), each rounded once (mu 0
// where s = 0).
template <typename T>
__device__ __forceinline__ int mu_bin_exact(T r2, T adz, T aux) {
    typedef Ar<T> A;
    const T s = A::sqrt(r2);
    const T mu = s > (T)0 ? A::div(adz, s) : (T)0;
    return (int)A::mul(mu, aux);
}

__device__ __forceinline__ int mu_bin(double r2, double adz, double aux) {
    return mu_bin_exact(r2, adz, aux);
}

// The same number from one approximate reciprocal root and two products
// wherever that estimate lies further from an integer than its error can
// reach; the root and the quotient are taken only for the few pairs in 10^4
// that lie closer (or where the estimate is not a number: r2 of 0). The
// estimate is within 2^-22.9 + 2^-23 of the true mu * aux, the exact chain
// within 3 * 2^-24: both within aux * 2^-20 of each other in absolute terms,
// against a margin of aux * 2^-18.
__device__ __forceinline__ int mu_bin(float r2, float adz, float aux) {
    float rs;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(rs) : "f"(r2));
    const float v = __fmul_rn(__fmul_rn(adz, rs), aux);
    const float fl = floorf(v);
    const float frac = __fsub_rn(v, fl);
    const float margin = __fmul_rn(aux, 3.814697265625e-6f);
    if (frac > margin && frac < __fsub_rn(1.f, margin)) return (int)fl;
    return mu_bin_exact(r2, adz, aux);
}

// The flat bin nb2 * b1 + b2 of a pair in range: b1 counts the inner squared
// edges that r2 has reached (right-open bins); b2 is floor(adz) (rppi), or
// min(int(mu * aux), nb2 - 1) with mu = adz / s, 0 where s = 0 (smu).
template <typename T, int MODE, bool LUT>
__device__ __forceinline__ int bin_of(T r2, T adz, const Bins<T, LUT>& e, int nb1, int nb2,
                                      T aux) {
    typedef Ar<T> A;
    int b2;
    if (MODE == MODE_RPPI) {
        b2 = (int)adz;
    } else {
        b2 = mu_bin(r2, adz, aux);
        b2 = min(b2, nb2 - 1);
    }
    return e.count(r2, nb1) * nb2 + b2;
}

// dynamic shared memory of both kernels: the edges (or the table's `ncell`
// edges and counts), then `ncopy` int32 histograms (one a warp, or one a block
// where the bins are many)
template <typename T>
__host__ __device__ inline size_t hist_smem(int nb1, int nb2, int ncopy, int ncell) {
    const size_t head = ncell > 0 ? (sizeof(T) + sizeof(int)) * (size_t)ncell
                                  : sizeof(T) * (size_t)(nb1 + 1);
    return (head + 15) / 16 * 16 + sizeof(int) * (size_t)nb1 * nb2 * ncopy;
}

// Zero the histograms, copy the edges or the table in, and fill `bins`.
// Returns the histograms.
template <typename T, bool LUT>
__device__ __forceinline__ int* hist_setup(unsigned char* dyn, const T* __restrict__ edges2,
                                           int nb1, int nbins, int ncopy, int threads,
                                           const T* __restrict__ lut_edge,
                                           const int* __restrict__ lut_base, int ncell, int shift,
                                           int key0, Bins<T, LUT>* bins) {
    T* edge = reinterpret_cast<T*>(dyn);
    int* base = reinterpret_cast<int*>(edge + ncell);
    int* hist = reinterpret_cast<int*>(dyn + hist_smem<T>(nb1, 0, 0, LUT ? ncell : 0));
    for (int b = threadIdx.x; b < nbins * ncopy; b += threads) hist[b] = 0;
    if (LUT) {
        for (int k = threadIdx.x; k < ncell; k += threads) {
            edge[k] = lut_edge[k];
            base[k] = lut_base[k];
        }
    } else {
        for (int k = threadIdx.x; k <= nb1; k += threads) edge[k] = edges2[k];
    }
    bins->lo = edges2[0];
    bins->hi = edges2[nb1];
    bins->shift = shift;
    bins->key0 = key0;
    bins->edge = edge;
    bins->base = base;
    return hist;
}

__device__ __forceinline__ void flush_hist(const int* hist, int nbins, int ncopy, int threads,
                                           unsigned long long* out) {
    for (int b = threadIdx.x; b < nbins; b += threads) {
        long long v = 0;
        for (int c = 0; c < ncopy; ++c) v += hist[c * nbins + b];
        if (v) atomicAdd(&out[b], (unsigned long long)v);
    }
}

// ---- K4 ---------------------------------------------------------------------

__device__ __forceinline__ int cell_of(float a, float inv, int nc) {
    return min(max((int)__fmul_rn(a, inv), 0), nc - 1);
}

// One tile's pairs: each thread's K4_POINTS points against every TB-th entry.
// SHIFT: subtract the entries' wrap shifts (false where every shift of the
// tile is 0, or the per-pair round is taken).
template <int MODE, bool WRAP, bool SHIFT, bool SELF, bool LUT>
__device__ __forceinline__ void tile_pairs(const float4* tq, const float4* tw, int jn, int tb,
                                           int TB, const float* px, const float* py,
                                           const float* pz, const int* ia, float lbox,
                                           const Bins<float, LUT>& edges, int nb1, int nb2,
                                           float nb2f, float aux, int* hist, int hoff) {
    for (int j = tb; j < jn; j += TB) {
        const float4 q = tq[j];
        float4 w;
        if (SHIFT) w = tw[j];
        const int qw = __float_as_int(q.w);
        const int mult = (qw & 1) + 1;
#pragma unroll
        for (int r = 0; r < K4_POINTS; ++r) {
            float dx = __fsub_rn(px[r], q.x), dy = __fsub_rn(py[r], q.y),
                  dz = __fsub_rn(pz[r], q.z);
            if (SHIFT) {
                dx = __fsub_rn(dx, w.x);
                dy = __fsub_rn(dy, w.y);
                dz = __fsub_rn(dz, w.z);
            } else if (!WRAP) {
                dx = min_image(dx, lbox);
                dy = min_image(dy, lbox);
                dz = min_image(dz, lbox);
            }
            const float adz = fabsf(dz);
            float r2;
            bool ok = in_range<float, MODE, LUT>(dx, dy, adz, edges, nb2f, &r2);
            if (SELF) ok = ok && (qw >> 1) != ia[r];
            if (ok) {
                const int bin = bin_of<float, MODE, LUT>(r2, adz, edges, nb1, nb2, aux);
                atomicAdd(&hist[hoff + bin], mult);
            }
        }
    }
}

template <int MODE, bool WRAP, bool SELF, bool LUT>
__global__ void __launch_bounds__(K4_THREADS)
pair_count_cells_kernel(const float* __restrict__ ax, const float* __restrict__ ay,
                        const float* __restrict__ az, const float* __restrict__ bx,
                        const float* __restrict__ by, const float* __restrict__ bz,
                        const int* __restrict__ starts_b, const int* __restrict__ work,
                        const int4* __restrict__ rows, int nrows, int nc, int groups_per_row,
                        float inv, float lbox, const float* __restrict__ edges2, int nb1, int nb2,
                        float aux, int skip_self, int ncopy,
                        const float* __restrict__ lut_edge, const int* __restrict__ lut_base,
                        int ncell, int shift, int key0, unsigned long long* __restrict__ out) {
    const int item = blockIdx.x;
    const int group = work[3 * item], begin = work[3 * item + 1], end = work[3 * item + 2];
    const int na = end - begin;
    if (na <= 0) return;

    // x, y, z of a second-side point and 2 * its index + its piece's multiplicity - 1
    __shared__ float4 tq[K4_TILE];
    __shared__ float4 tw[K4_TILE];  // its piece's wrap shift
    __shared__ int seg_cum[K4_SLOTS + 1];
    __shared__ int seg_sb[K4_SLOTS];
    __shared__ float4 seg_w[K4_SLOTS];
    extern __shared__ __align__(16) unsigned char dyn[];
    const int nbins = nb1 * nb2;
    const int t = threadIdx.x;
    Bins<float, LUT> edges;
    int* hist = hist_setup<float, LUT>(dyn, edges2, nb1, nbins, ncopy, K4_THREADS, lut_edge,
                                       lut_base, ncell, shift, key0, &edges);
    // this warp's histogram; opaque, so that it stays in a register instead
    // of being worked out again at every add
    int hoff = ncopy > 1 ? (t >> 5) * nbins : 0;
    asm volatile("" : "+r"(hoff));
    const float nb2f = (float)nb2;

    // the pieces: for walk row r the neighbour row's cells k0 - Kd .. k1 + Kd,
    // cut at the box faces: piece 0 inside, 1 below 0, 2 past nc - 1
    const int row = group / groups_per_row;
    const int ci = row / nc, cj = row % nc;
    const int k0 = cell_of(az[begin], inv, nc), k1 = cell_of(az[end - 1], inv, nc);
    const int nslots = 3 * nrows;
    for (int s = t; s < nslots; s += K4_THREADS) {
        const int piece = s / nrows;
        const int4 r = rows[s - piece * nrows];
        int ni = ci + r.x, nj = cj + r.y;
        const int wi = ni < 0 ? -1 : (ni >= nc ? 1 : 0);
        const int wj = nj < 0 ? -1 : (nj >= nc ? 1 : 0);
        ni -= wi * nc;
        nj -= wj * nc;
        const int klo = k0 - r.z, khi = k1 + r.z;
        int ka, kb, wk;
        if (piece == 0) {
            ka = max(klo, 0), kb = min(khi, nc - 1), wk = 0;
        } else if (piece == 1) {
            ka = klo + nc, kb = nc - 1, wk = -1;
        } else {
            ka = 0, kb = khi - nc, wk = 1;
        }
        int sb = 0, len = 0;
        if (ka <= kb) {
            const int base = (ni * nc + nj) * nc;
            sb = starts_b[base + ka];
            len = starts_b[base + kb + 1] - sb;
        }
        seg_cum[s] = len;
        seg_sb[s] = sb;
        seg_w[s] = make_float4((float)wi * lbox, (float)wj * lbox, (float)wk * lbox,
                               __int_as_float(r.w));
    }
    __syncthreads();
    // exclusive prefix sum of the pieces' lengths, by the first warp
    if (t < 32) {
        int carry = 0;
        for (int base = 0; base < nslots; base += 32) {
            const int idx = base + t;
            const int v = idx < nslots ? seg_cum[idx] : 0;
            int inc = v;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int n = __shfl_up_sync(0xffffffffu, inc, o);
                if (t >= o) inc += n;
            }
            if (idx < nslots) seg_cum[idx] = carry + inc - v;
            carry += __shfl_sync(0xffffffffu, inc, 31);
        }
        if (t == 0) seg_cum[nslots] = carry;
    }
    __syncthreads();
    const int total = seg_cum[nslots];

    // TA lanes along the item's points (K4_POINTS a lane), TB along the tile
    int la = 0;
    while ((K4_POINTS << la) < na) ++la;
    const int TA = 1 << la;
    const int ta = t & (TA - 1);
    const int tb = t >> la;
    const int TB = K4_THREADS >> la;
    float px[K4_POINTS], py[K4_POINTS], pz[K4_POINTS];
    int ia[K4_POINTS];
#pragma unroll
    for (int r = 0; r < K4_POINTS; ++r) {
        const int k = ta + r * TA;
        const bool active = k < na;
        ia[r] = active && skip_self ? begin + k : -1;
        px[r] = active ? ax[begin + k] : Ar<float>::nan();
        py[r] = active ? ay[begin + k] : 0.f;
        pz[r] = active ? az[begin + k] : 0.f;
    }

    for (int p0 = 0; p0 < total; p0 += K4_TILE) {
        const int jn = min(K4_TILE, total - p0);
        __syncthreads();
        int shifted = 0;
        for (int u = t; u < jn; u += K4_THREADS) {
            const int pos = p0 + u;
            // the last piece that begins at or before pos (an empty piece
            // shares its begin with the next one)
            int lo = 0, hi = nslots;
            while (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                if (seg_cum[mid] <= pos) lo = mid; else hi = mid;
            }
            const int j = seg_sb[lo] + (pos - seg_cum[lo]);
            const float4 w = seg_w[lo];
            tq[u] = make_float4(bx[j], by[j], bz[j],
                                __int_as_float(2 * j + __float_as_int(w.w) - 1));
            tw[u] = w;
            shifted |= (w.x != 0.f) | (w.y != 0.f) | (w.z != 0.f);
        }
        // pieces inside the box on every axis (all but the items at its faces)
        // have no shift to subtract: x - 0 is x
        if (__syncthreads_or(shifted) && WRAP) {
            tile_pairs<MODE, WRAP, true, SELF, LUT>(tq, tw, jn, tb, TB, px, py, pz, ia, lbox, edges,
                                                   nb1, nb2, nb2f, aux, hist, hoff);
        } else {
            tile_pairs<MODE, WRAP, false, SELF, LUT>(tq, tw, jn, tb, TB, px, py, pz, ia, lbox,
                                                    edges, nb1, nb2, nb2f, aux, hist, hoff);
        }
    }
    __syncthreads();
    flush_hist(hist, nbins, ncopy, K4_THREADS, out);
}

struct CellArgs {
    const float *ax, *ay, *az, *bx, *by, *bz;
    const int *starts_b, *work;
    int nitems;
    const int4* rows;
    int nrows, nc, groups_per_row;
    float inv, lbox;
    const float* edges2;
    int nb1, nb2;
    float aux;
    int skip_self, ncopy;
    const float* lut_edge;
    const int* lut_base;
    int ncell, shift, key0;
    unsigned long long* out;
    cudaStream_t s;
};

template <int MODE, bool WRAP, bool SELF, bool LUT>
cudaError_t launch_cells(const CellArgs& a) {
    const size_t smem = hist_smem<float>(a.nb1, a.nb2, a.ncopy, LUT ? a.ncell : 0);
    auto kernel = pair_count_cells_kernel<MODE, WRAP, SELF, LUT>;
    if (smem > 32 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<a.nitems, K4_THREADS, smem, a.s>>>(
        a.ax, a.ay, a.az, a.bx, a.by, a.bz, a.starts_b, a.work, a.rows, a.nrows, a.nc,
        a.groups_per_row, a.inv, a.lbox, a.edges2, a.nb1, a.nb2, a.aux, a.skip_self, a.ncopy,
        a.lut_edge, a.lut_base, a.ncell, a.shift, a.key0, a.out);
    return cudaGetLastError();
}

// Without a bin table (ncell 0) one general instance a mode: the per-pair
// round, which is right on every grid, and the index test, whose indices are
// -1 where no pair is to be skipped.
template <int MODE, bool WRAP>
cudaError_t launch_cells_self(const CellArgs& a) {
    if (a.ncell <= 0) return launch_cells<MODE, false, true, false>(a);
    return a.skip_self ? launch_cells<MODE, WRAP, true, true>(a)
                       : launch_cells<MODE, WRAP, false, true>(a);
}

// ---- K5 ---------------------------------------------------------------------

template <typename T, int MODE, bool PERIOD, bool SELF, bool LUT>
__global__ void __launch_bounds__(K5_THREADS)
pair_count_all_kernel(const T* __restrict__ x1, const T* __restrict__ y1, const T* __restrict__ z1,
                      int n1, const T* __restrict__ x2, const T* __restrict__ y2,
                      const T* __restrict__ z2, int n2, int jchunk, T lbox, T tround,
                      const T* __restrict__ edges2, int nb1, int nb2, T aux, int skip_self,
                      int row0, int ncopy, const T* __restrict__ lut_edge,
                      const int* __restrict__ lut_base, int ncell, int shift, int key0,
                      unsigned long long* __restrict__ out) {
    __shared__ T tx[K5_TILE], ty[K5_TILE], tz[K5_TILE];
    extern __shared__ __align__(16) unsigned char dyn[];
    const int nbins = nb1 * nb2;
    const int t = threadIdx.x;
    Bins<T, LUT> edges;
    int* hist = hist_setup<T, LUT>(dyn, edges2, nb1, nbins, ncopy, K5_THREADS, lut_edge, lut_base,
                                   ncell, shift, key0, &edges);
    int hoff = ncopy > 1 ? (t >> 5) * nbins : 0;
    asm volatile("" : "+r"(hoff));
    const T nb2f = (T)nb2;

    T px[K5_POINTS], py[K5_POINTS], pz[K5_POINTS];
    int ia[K5_POINTS];
#pragma unroll
    for (int r = 0; r < K5_POINTS; ++r) {
        const long long i = ((long long)blockIdx.x * K5_POINTS + r) * K5_THREADS + t;
        const bool active = i < n1;
        // the row's index in the second set: a shard of an autocorrelation
        // starts at row0 there
        ia[r] = active && skip_self ? (int)i + row0 : -1;
        px[r] = active ? x1[i] : Ar<T>::nan();
        py[r] = active ? y1[i] : (T)0;
        pz[r] = active ? z1[i] : (T)0;
    }
    const int jbegin = blockIdx.y * jchunk;
    const int jend = min(n2, jbegin + jchunk);
    for (int j0 = jbegin; j0 < jend; j0 += K5_TILE) {
        const int jn = min(K5_TILE, jend - j0);
        __syncthreads();
        if (t < jn) {
            tx[t] = x2[j0 + t];
            ty[t] = y2[j0 + t];
            tz[t] = z2[j0 + t];
        }
        __syncthreads();
        for (int j = 0; j < jn; ++j) {
            const T qx = tx[j], qy = ty[j], qz = tz[j];
#pragma unroll
            for (int r = 0; r < K5_POINTS; ++r) {
                T dx = Ar<T>::sub(px[r], qx), dy = Ar<T>::sub(py[r], qy),
                  dz = Ar<T>::sub(pz[r], qz);
                if (PERIOD) {
                    dx = min_image_one_period(dx, lbox, tround);
                    dy = min_image_one_period(dy, lbox, tround);
                    dz = min_image_one_period(dz, lbox, tround);
                } else {
                    dx = min_image(dx, lbox);
                    dy = min_image(dy, lbox);
                    dz = min_image(dz, lbox);
                }
                const T adz = Ar<T>::abs(dz);
                T r2;
                bool ok = in_range<T, MODE, LUT>(dx, dy, adz, edges, nb2f, &r2);
                if (SELF) ok = ok && j0 + j != ia[r];
                if (ok) {
                    const int bin = bin_of<T, MODE, LUT>(r2, adz, edges, nb1, nb2, aux);
                    atomicAdd(&hist[hoff + bin], 1);
                }
            }
        }
    }
    __syncthreads();
    flush_hist(hist, nbins, ncopy, K5_THREADS, out);
}

struct AllArgs {
    const void *x1, *y1, *z1;
    int n1;
    const void *x2, *y2, *z2;
    int n2, jchunk;
    double lbox, tround;
    const void* edges2;
    int nb1, nb2;
    double aux;
    int skip_self, row0, ncopy;
    const void* lut_edge;
    const int* lut_base;
    int ncell, shift, key0;
    unsigned long long* out;
    cudaStream_t s;
};

template <typename T, int MODE, bool PERIOD, bool SELF, bool LUT>
cudaError_t launch_all(const AllArgs& a) {
    const size_t smem = hist_smem<T>(a.nb1, a.nb2, a.ncopy, LUT ? a.ncell : 0);
    auto kernel = pair_count_all_kernel<T, MODE, PERIOD, SELF, LUT>;
    if (smem > 32 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
    }
    const int rows = K5_THREADS * K5_POINTS;
    const dim3 grid((a.n1 + rows - 1) / rows, (a.n2 + a.jchunk - 1) / a.jchunk);
    kernel<<<grid, K5_THREADS, smem, a.s>>>(
        (const T*)a.x1, (const T*)a.y1, (const T*)a.z1, a.n1, (const T*)a.x2, (const T*)a.y2,
        (const T*)a.z2, a.n2, a.jchunk, (T)a.lbox, (T)a.tround, (const T*)a.edges2, a.nb1, a.nb2,
        (T)a.aux, a.skip_self, a.row0, a.ncopy, (const T*)a.lut_edge, a.lut_base, a.ncell, a.shift,
        a.key0, a.out);
    return cudaGetLastError();
}

// Without a bin table (ncell 0) one general instance a type and mode: the
// division, and the index test with indices of -1 where no pair is skipped.
template <typename T, int MODE>
cudaError_t launch_all_period(const AllArgs& a, int one_period) {
    if (a.ncell <= 0) return launch_all<T, MODE, false, true, false>(a);
    if (one_period)
        return a.skip_self ? launch_all<T, MODE, true, true, true>(a)
                           : launch_all<T, MODE, true, false, true>(a);
    return a.skip_self ? launch_all<T, MODE, false, true, true>(a)
                       : launch_all<T, MODE, false, false, true>(a);
}

}  // namespace

// K4: add the pair counts of `nitems` work items (rows of `work`: group, begin,
// end into the first side's sorted columns; a group is `span` consecutive
// cells of one (ci, cj) row, groups_per_row of them a row) against the second
// side's cells into out[nb1 * nb2]. `rows` holds nrows <= 25 int32 (di, dj, Kd,
// multiplicity) rows of the walk; inv = nc / lbox as the stage computed it.
// mode 0 is rppi, 1 is smu; use_wrap picks the item-constant minimum image;
// skip_self skips the pair of a point with itself by index; ncopy is the
// number of shared histograms (4: one a warp, or 1). Returns cudaGetLastError().
extern "C" int pair_count_cells(const float* ax, const float* ay, const float* az,
                                const float* bx, const float* by, const float* bz,
                                const int* starts_b, const int* work, int nitems, const int* rows,
                                int nrows, int nc, int groups_per_row, float inv, float lbox,
                                const float* edges2, int nb1, int nb2, float aux, int mode,
                                int use_wrap, int skip_self, int ncopy, const float* lut_edge,
                                const int* lut_base, int ncell, int shift, int key0,
                                unsigned long long* out, void* stream) {
    if (nitems <= 0 || nrows <= 0) return (int)cudaSuccess;
    if (nrows > K4_MAX_ROWS || (ncopy != 1 && ncopy != K4_THREADS / 32))
        return (int)cudaErrorInvalidValue;
    const CellArgs a = {ax, ay, az, bx, by, bz, starts_b, work, nitems,
                        reinterpret_cast<const int4*>(rows), nrows, nc, groups_per_row, inv, lbox,
                        edges2, nb1, nb2, aux, skip_self, ncopy, lut_edge, lut_base, ncell, shift,
                        key0, out, (cudaStream_t)stream};
    switch (2 * mode + (use_wrap ? 1 : 0)) {
        case 0: return (int)launch_cells_self<MODE_RPPI, false>(a);
        case 1: return (int)launch_cells_self<MODE_RPPI, true>(a);
        case 2: return (int)launch_cells_self<MODE_SMU, false>(a);
        case 3: return (int)launch_cells_self<MODE_SMU, true>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K5: add the counts of all n1 x n2 pairs into out[nb1 * nb2]; each block
// takes 512 rows of the first set and `jchunk` of the second. The columns and
// edges are float (is_f64 = 0) or double (1). one_period: every difference
// lies within 1.5 lbox and `tround` is the largest value whose quotient by
// lbox rounds to 0. skip_self skips pair (i, j) where row0 + i == j: the
// first set is rows row0 .. row0 + n1 of the second (a shard of an
// autocorrelation), or the second itself with row0 = 0.
extern "C" int pair_count_all(const void* x1, const void* y1, const void* z1, int n1,
                              const void* x2, const void* y2, const void* z2, int n2, int jchunk,
                              double lbox, double tround, const void* edges2, int nb1, int nb2,
                              double aux, int mode, int skip_self, int row0, int is_f64,
                              int one_period,
                              int ncopy, const void* lut_edge, const int* lut_base, int ncell,
                              int shift, int key0, unsigned long long* out, void* stream) {
    if (n1 <= 0 || n2 <= 0) return (int)cudaSuccess;
    if (ncopy != 1 && ncopy != K5_THREADS / 32) return (int)cudaErrorInvalidValue;
    const AllArgs a = {x1, y1, z1, n1, x2, y2, z2, n2, jchunk, lbox, tround, edges2,
                       nb1, nb2, aux, skip_self, row0, ncopy, lut_edge, lut_base, ncell, shift,
                       key0, out, (cudaStream_t)stream};
    switch (2 * mode + (is_f64 ? 1 : 0)) {
        case 0: return (int)launch_all_period<float, MODE_RPPI>(a, one_period);
        case 1: return (int)launch_all_period<double, MODE_RPPI>(a, one_period);
        case 2: return (int)launch_all_period<float, MODE_SMU>(a, one_period);
        case 3: return (int)launch_all_period<double, MODE_SMU>(a, one_period);
        default: return (int)cudaErrorInvalidValue;
    }
}
