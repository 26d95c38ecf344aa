// Mode binning of rfft meshes: K3, all auto and cross P(k) bin sums of T
// meshes with optional Legendre pole rows, and K2, the binned power of one
// mesh, which is this kernel at T = 1 without poles.
//
// Replaces abacusutils_tpu/ops/power.py:_segsum_matmul (K2: the one-hot bin
// contraction on the TPU's MXU, fed by |delta_k / W|^2 materialised in device
// memory), _segsum_matmul_pairs (pairs stacked as extra LHS rows of one bin
// one-hot, pole weights as further rows) and the pole sums of
// _bin_kmu_planned (a gather by a sorted plan plus cumsums over k bounds),
// and the per-pair _segsum_matmul loop of models/pipeline.py:
// hod_pk_fused_multi / pk_grouped_multi. For every mode m of the
// (n1d, n1d, n1d/2+1) complex64 meshes d_0 .. d_{T-1} in a bin it forms
//
//   d_t' = d_t[m] * scale / (W[ix] W[iy] W[kz])           (t < T)
//   v_ij = Re(d_i' conj(d_j'))                             (i <= j, i-major)
//
// and adds dup(kz) * v_ij to bin seg[m] of pair (i, j) (seg == nbins marks a
// mode outside every bin). dup is the Hermitian factor: 1 on the kz=0 plane
// and on the kz=n1d/2 plane of an even mesh, 2 elsewhere. With NP > 0
// non-zero poles l_q it also adds (2 l_q + 1) L_{l_q}(mu) dup * v_ij to
// k-bin seg[m] / nmu of pole row q of the pair. mu^2 = kz^2 / |k|^2 from the
// integer |k|^2 (within 2 ulp of the plan's f32 value), and L_l is
// evaluated in registers as mu^(l mod 2) * sum_j c_j (mu^2)^j.
//
// What bounds it on the H100: device memory, 8T + 4 bytes for each mode in a
// bin (its T values and its bin), and nothing for the others. Modes with
// |k| >= k_max lie in no bin: 48 % of a 256^3 mesh binned to Nyquist, 90 %
// of a 550^3 mesh binned to 0.5 h/Mpc. What the design does about it:
//
// - Row spans. Along kz in one (ix, iy) row |k|^2 grows, so a plan's in-bin
//   modes of a row form one interval [lo, hi). The plan keeps these spans
//   (ops/power.py:row_spans) and two lists of the non-empty groups of four
//   neighbouring rows: along y (iy0 .. iy0+3 at one ix) and along x (ix0 ..
//   ix0+3 at one iy). A warp takes one group as a tile of 4 rows x 8 kz, and
//   only in-span modes read seg and the fields. The launch takes the list
//   whose four rows lie side by side in memory, so that the rows' values at
//   one kz fill one 32-byte sector:
//   - along y where sx >= sy: cuFFT's rfftn layout (iy fastest, then ix, kz
//     slowest), and kz-contiguous meshes, where a row's 8 kz fill two
//     sectors either way;
//   - along x where sx < sy: the ky slabs of parallel/fft.py:slab_rfftn,
//     whose last fft runs along x and leaves x fastest. Along y there, each
//     lane's 8 bytes take a sector of their own: 4x the bytes, and 3.43 ms
//     against 0.77 along x for three 512^3 meshes on an H100.
//   seg (kz fastest) gives a full sector a row on either list: every sector
//   a warp loads is used whole. A mode in a span whose seg is outside every
//   bin is skipped, so any seg gives the right sums.
// - Index arithmetic once a row of the tile (each lane computes its own
//   row's): ix, iy, scale / (W[ix] W[iy]), the pole form's kx^2 + ky^2 and
//   the 64-bit bases; 1 / W[kz] comes from shared memory, so a mode costs no
//   division (one fast one for mu^2 in the pole form). The ragged last group
//   of either list (iy >= ny, or ix >= n1d: n1d = 45 or 550) has empty rows.
// - Run-aggregated adds. Along kz in a row, seg and the k-bin seg / nmu do
//   not decrease, so equal bins form runs of lanes. A segmented scan over
//   each row's 8 lanes (__shfl_up_sync, as many steps as the longest run
//   needs, at most 3) leaves each run's sum on its last lane, for every pair
//   at once, so the scans of all pairs overlap. sm_90a has no native shared
//   f32 add (atomicAdd is a compare-and-swap loop), so the run ends add
//   with plain read-modify-writes to histograms of the warp's own: one for
//   each row of the tile where 8 warps' four copies fit in 48 KB (K2), else
//   one a warp, into which the rows' run ends with one bin
//   (__match_any_sync) are first added onto the lowest such lane, in lane
//   order. A row whose run ends could repeat a key (a seg that is no plan's)
//   takes the merge too, so any seg gives the right sums.
// - A deterministic flush. A few persistent blocks per SM; each sums its
//   warps' histograms in order into its partial; a second kernel sums the
//   partials in a fixed order in f64 and writes the output type (f32 for
//   K2, f64 for K3). Nothing is zeroed first, there are no atomics, and two
//   launches on the same inputs give the same bits.
// - Loads in flight: U steps of the tile (4 at T <= 2, 2 at T <= 4, else 1),
//   all of their loads issued before their sums.
//
// What holds it back now (NVIDIA H100, PERF.md): the shuffle and shared-
// memory pipe, not device memory. Per 32 modes the pole form at T = 3
// scans and merges 18 values and makes 18 shared read-modify-writes.
//
// A ky slab: the meshes may be the rows y0 .. y0 + ny of the full
// (n1d, n1d, n1d/2+1) spectrum, laid out (n1d, ny, n1d/2+1) as the y-sharded
// output of parallel/fft.py:slab_rfftn is (x fastest: the x-grouped list),
// with a plan of those rows (ops/power.py:mode_bin_plan_device(yslab=)): seg
// and the row spans index the slab's rows, W and |k| the global iy = y0 +
// local iy. ny = n1d and y0 = 0 is the whole mesh.
//
// What holds the x-grouped form back (NVIDIA H100 80GB HBM3, 700 W; three
// 512^3 meshes, scripts/torch/bin_compare.py): 0.77 ms, against 0.60 on the
// same rows made kz-contiguous and 0.76 for the y-grouped form on rfftn's
// y-fastest layout. On either fast-axis layout a warp's load of 4 rows x 8
// kz takes eight 32-byte sectors from eight lines a kz plane apart, where
// kz-contiguous rows give four 64-byte runs; a pitch that is no power of
// two does not help (0.83 ms), so it is the lines and DRAM pages a load
// touches, not channel aliasing. Tiles of 8 rows x 4 kz along the fast axis
// would touch four. The pole form at T = 1 is held by its scans and merges
// on any layout (0.70 ms on slab_rfftn's, 0.69 contiguous).

// T (1..8) and NP (0..4) are template parameters, so the field, pair and
// pole loops unroll into registers. Host-side, each instance's shared-memory
// attribute is set once per device; the wrapper caches the occupancy.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 8;
constexpr int kMaxPoles = 4;
constexpr int kMaxTerms = 5;  // (mu^2)^0 .. (mu^2)^4: degrees up to 8
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kRows = 4;          // rows of a warp's tile
constexpr int kCols = 8;          // kz of a warp's tile
constexpr int kReduceWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Fields {
    const float2* p[kMaxFields];
};

// L_l(mu) = mu^odd[q] * sum_j c[q][j] (mu^2)^j, scaled by norm[q] = 2 l + 1
struct Poles {
    float c[kMaxPoles][kMaxTerms];
    float norm[kMaxPoles];
    int odd[kMaxPoles];
};

template <int T>
__host__ __device__ constexpr int unroll() {
    return T <= 2 ? 4 : (T <= 4 ? 2 : 1);
}

// How a warp's lanes (lane = 8 row + col) combine their values by key
// (key < 0: a lane that adds nothing). steps and rounds are the same on
// every lane.
struct Runs {
    int start;          // this lane's run (within its row) begins at lane `start`
    int steps;          // scan steps for the longest run: ceil(log2(longest))
    int rounds;         // most partners any lane takes
    unsigned partners;  // run ends of this lane's key whose sums it adds in
    bool add;           // this lane adds its sums to the histogram
};

__device__ __forceinline__ Runs runs_of(int key, int lane, bool merge) {
    Runs r;
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, (lane & (kCols - 1)) == 0 || prev != key);
    r.start = 31 - __clz(heads & (kFull >> (31 - lane)));
    const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
    // the longest run that adds (lanes outside a span do not)
    const unsigned longest =
        __reduce_max_sync(kFull, key >= 0 ? (unsigned)(lane - r.start + 1) : 1u);
    r.steps = 32 - __clz((int)(longest - 1));
    const bool end = last && key >= 0;
    if (!merge) {
        // Each row adds to a histogram of its own. Its run ends hold distinct
        // keys when its adding lanes are contiguous and their keys do not
        // decrease, as for a plan's seg; otherwise merge as one histogram.
        const int col = lane & (kCols - 1);
        const unsigned valid = __ballot_sync(kFull, key >= 0);
        const unsigned v = (valid >> (lane - col)) & ((1u << kCols) - 1u);
        const unsigned w = v ? v >> (__ffs(v) - 1) : 0u;
        const bool ordered = (w & (w + 1u)) == 0 && (col == 0 || key < 0 || prev <= key);
        merge = !__all_sync(kFull, ordered);
    }
    if (!merge) {
        r.add = end;
        r.partners = 0u;
        r.rounds = 0;
        return r;
    }
    // run ends with one key: the lowest lane adds the others' sums
    const unsigned same = __match_any_sync(kFull, end ? key : -2 - lane);
    r.add = end && (same & (0u - same)) == (1u << lane);
    r.partners = r.add ? same & ~(1u << lane) : 0u;
    r.rounds = (int)__reduce_max_sync(kFull, (unsigned)__popc(r.partners));
    return r;
}

// Leave on each adding lane the sum of x over every lane of its key: a
// segmented scan within the row, then the partners' run sums in lane order.
template <int N>
__device__ __forceinline__ void add_partner(float (&x)[N], unsigned& rest, int lane) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1u;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const float y = __shfl_sync(kFull, x[i], src);
        if (src != lane) x[i] += y;
    }
}

template <int N>
__device__ __forceinline__ void combine(float (&x)[N], const Runs& r, int lane) {
    // a run lies within one row's kCols lanes: at most log2(kCols) steps,
    // unrolled with their shift distances fixed
#pragma unroll
    for (int s = 0; (1 << s) < kCols; ++s) {
        if (s < r.steps) {
            const bool take = lane - (1 << s) >= r.start;
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const float y = __shfl_up_sync(kFull, x[i], 1 << s);
                if (take) x[i] += y;
            }
        }
    }
    // a plan's seg gives a lane at most one partner in each other row
    unsigned rest = r.partners;
#pragma unroll
    for (int k = 0; k < kRows - 1; ++k) {
        if (k < r.rounds) add_partner(x, rest, lane);
    }
    for (int k = kRows - 1; k < r.rounds; ++k) add_partner(x, rest, lane);
}

// h[i * stride] += x[i] on the adding lanes: every load, then every store
template <int N>
__device__ __forceinline__ void add_sums(float* h, int stride, const float (&x)[N], const Runs& r) {
    if (!r.add) return;
    float old[N];
#pragma unroll
    for (int i = 0; i < N; ++i) old[i] = h[i * stride];
#pragma unroll
    for (int i = 0; i < N; ++i) h[i * stride] = old[i] + x[i];
}

template <int T, int NP>
__global__ void __launch_bounds__(256)
mode_bin_pairs_kernel(Fields f, long long sx, long long sy, long long sz,
                      const int* __restrict__ seg, const int* __restrict__ groups, int ngroups,
                      const int* __restrict__ bounds, const float* __restrict__ W, float scale,
                      int n1d, int nbins, int nmu, Poles poles, int copies,
                      float* __restrict__ partials, int ny, int y0, int xgroups) {
    constexpr int NPAIR = T * (T + 1) / 2;
    constexpr int U = unroll<T>();
    const int nk = NP > 0 ? nbins / nmu : 0;
    const int hrow = nbins + NP * nk;  // one pair's histogram: bins, then pole rows
    const int H = NPAIR * hrow;
    const int kzlen = n1d / 2 + 1;
    const int nwarps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int trow = lane / kCols;  // the lane's row in the tile
    const int col = lane % kCols;   // its kz offset

    extern __shared__ float smem[];
    float* winv = smem;          // [kzlen] 1 / W[kz], 1 without W
    float* hist = smem + kzlen;  // [nwarps][copies][NPAIR][hrow]
    for (int i = threadIdx.x; i < kzlen; i += blockDim.x) winv[i] = W != nullptr ? 1.f / W[i] : 1.f;
    for (int i = threadIdx.x; i < nwarps * copies * H; i += blockDim.x) hist[i] = 0.f;
    __syncthreads();
    // one histogram a warp (run ends of the four rows merged), or one a row
    const bool merge = copies == 1;
    float* h = hist + (warp * copies + (merge ? 0 : trow)) * H;

    const bool even = (n1d & 1) == 0;
    const int half = n1d / 2;
    const int gpy = (ny + kRows - 1) / kRows;   // groups of the y list an ix
    const int gpx = (n1d + kRows - 1) / kRows;  // groups of the x list an iy
    for (int item = blockIdx.x * nwarps + warp; item < ngroups; item += gridDim.x * nwarps) {
        const int gid = groups[item];
        int ix, ly;  // the row in the slab (ly: its local iy)
        bool row_ok;
        if (xgroups) {  // id ly * gpx + ix / 4: the tile's rows run along x
            ly = gid / gpx;
            ix = (gid - ly * gpx) * kRows + trow;
            row_ok = ix < n1d;
        } else {  // id ix * gpy + ly / 4: they run along y
            ix = gid / gpy;
            ly = (gid - ix * gpy) * kRows + trow;
            row_ok = ly < ny;
        }
        const int iy = y0 + ly;  // the row's iy in the mesh
        const int r = ix * ny + ly;
        const int lo = row_ok ? bounds[2 * r] : 0;
        const int hi = row_ok ? bounds[2 * r + 1] : 0;
        const int klo = (int)__reduce_min_sync(kFull, hi > lo ? (unsigned)lo : 0xffffffffu);
        const int khi = (int)__reduce_max_sync(kFull, (unsigned)hi);
        const float grow = W != nullptr && row_ok ? scale / (W[ix] * W[iy]) : scale;
        const int fx = ix < half ? ix : ix - n1d;
        const int fy = iy < half ? iy : iy - n1d;
        const int kperp2 = fx * fx + fy * fy;
        const int* srow = seg + (long long)r * kzlen;
        const long long frow = ix * sx + ly * sy;

        for (int k0 = klo; k0 < khi; k0 += kCols * U) {
            int s[U];
            float2 v[U][T];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int kz = k0 + kCols * u + col;
                const bool in = kz >= lo && kz < hi;
                s[u] = in ? __ldg(srow + kz) : -1;
                const long long at = frow + (long long)kz * sz;
#pragma unroll
                for (int t = 0; t < T; ++t) {
                    v[u][t] = in ? __ldg(f.p[t] + at) : make_float2(0.f, 0.f);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (k0 + kCols * u >= khi) break;  // the same on every lane
                const int kz = k0 + kCols * u + col;
                const bool ok = s[u] >= 0 && s[u] < nbins;
                const int key = ok ? s[u] : -1;
                const float g = ok ? grow * winv[kz] : 0.f;
                const float dup = (kz == 0 || (even && kz == kzlen - 1)) ? 1.f : 2.f;
                float re[T], im[T];
#pragma unroll
                for (int t = 0; t < T; ++t) {
                    re[t] = v[u][t].x * g;
                    im[t] = v[u][t].y * g;
                }
                float x[NPAIR];
                {
                    int p = 0;
#pragma unroll
                    for (int i = 0; i < T; ++i) {
#pragma unroll
                        for (int j = i; j < T; ++j, ++p) {
                            x[p] = dup * (re[i] * re[j] + im[i] * im[j]);
                        }
                    }
                }
                const Runs rb = runs_of(key, lane, merge);
                combine(x, rb, lane);
                add_sums(h + key, hrow, x, rb);
                if (NP > 0) {
                    const int k2 = kperp2 + kz * kz;
                    const float mu2 = k2 > 0 ? __fdividef((float)(kz * kz), (float)k2) : 0.f;
                    const float mu = sqrtf(mu2);
                    const int kkey = ok ? s[u] / nmu : -1;
                    const Runs rk = nmu > 1 ? runs_of(kkey, lane, merge) : rb;
#pragma unroll
                    for (int q = 0; q < NP; ++q) {
                        float acc = 0.f, pm = 1.f;
#pragma unroll
                        for (int j = 0; j < kMaxTerms; ++j) {
                            acc += poles.c[q][j] * pm;
                            pm *= mu2;
                        }
                        if (poles.odd[q]) acc *= mu;
                        const float pw = poles.norm[q] * acc * dup;
                        int p = 0;
#pragma unroll
                        for (int i = 0; i < T; ++i) {
#pragma unroll
                            for (int j = i; j < T; ++j, ++p) {
                                x[p] = (re[i] * re[j] + im[i] * im[j]) * pw;
                            }
                        }
                        combine(x, rk, lane);
                        add_sums(h + nbins + q * nk + kkey, hrow, x, rk);
                    }
                }
                __syncwarp();
            }
        }
    }
    __syncthreads();

    // the block's partial: its warps' histograms summed in warp order
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
        float acc = 0.f;
        for (int w = 0; w < nwarps * copies; ++w) acc += hist[w * H + i];
        partials[(long long)blockIdx.x * H + i] = acc;
    }
}

// out[i] = sum over blocks b of partials[b][i], in f64, in a fixed order:
// warp w of the block takes b = w, w + 32, ... in turn, then warp 0 adds
// the 32 warp sums in order.
template <typename OutT>
__global__ void __launch_bounds__(kReduceWarps * 32)
mode_bin_reduce_kernel(const float* __restrict__ partials, int nblocks, int H,
                       OutT* __restrict__ out) {
    __shared__ double part[kReduceWarps][33];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int i = blockIdx.x * 32 + lane;
    double acc = 0.0;
    if (i < H) {
        for (int b = warp; b < nblocks; b += kReduceWarps) {
            acc += (double)partials[(long long)b * H + i];
        }
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && i < H) {
        double s = 0.0;
        for (int w = 0; w < kReduceWarps; ++w) s += part[w][lane];
        out[i] = (OutT)s;
    }
}

using KernelFn = void (*)(Fields, long long, long long, long long, const int*, const int*, int,
                          const int*, const float*, float, int, int, int, Poles, int, float*, int,
                          int, int);

template <int T>
KernelFn kernel_np(int npoles) {
    switch (npoles) {
        case 0: return mode_bin_pairs_kernel<T, 0>;
        case 1: return mode_bin_pairs_kernel<T, 1>;
        case 2: return mode_bin_pairs_kernel<T, 2>;
        case 3: return mode_bin_pairs_kernel<T, 3>;
        case 4: return mode_bin_pairs_kernel<T, 4>;
        default: return nullptr;
    }
}

KernelFn kernel_for(int nfields, int npoles) {
    switch (nfields) {
        case 1: return kernel_np<1>(npoles);
        case 2: return kernel_np<2>(npoles);
        case 3: return kernel_np<3>(npoles);
        case 4: return kernel_np<4>(npoles);
        case 5: return kernel_np<5>(npoles);
        case 6: return kernel_np<6>(npoles);
        case 7: return kernel_np<7>(npoles);
        case 8: return kernel_np<8>(npoles);
        default: return nullptr;
    }
}

// The kernel instance of (nfields, npoles), its largest dynamic shared
// memory set once per device (a bit per device of `done`).
cudaError_t prepared(int nfields, int npoles, int dev, KernelFn* fn) {
    static unsigned long long done[kMaxFields + 1][kMaxPoles + 1] = {};
    if (nfields < 1 || nfields > kMaxFields || npoles < 0 || npoles > kMaxPoles || dev < 0 ||
        dev >= 64) {
        return cudaErrorInvalidValue;
    }
    *fn = kernel_for(nfields, npoles);
    unsigned long long& bits = done[nfields][npoles];
    if (!((bits >> dev) & 1ull)) {
        const cudaError_t e = cudaFuncSetAttribute(
            (const void*)*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (e != cudaSuccess) return e;
        bits |= 1ull << dev;
    }
    return cudaSuccess;
}

// The monomial coefficients of P_l: P_l(mu) = sum_k a_k mu^(l - 2k),
// a_k = (-1)^k C(l, k) C(2l - 2k, l) / 2^l, stored by the power of mu^2
// that remains after the factor mu^(l mod 2).
bool legendre(int l, float c[kMaxTerms]) {
    if (l < 1 || l > 2 * (kMaxTerms - 1)) return false;
    for (int j = 0; j < kMaxTerms; ++j) c[j] = 0.f;
    for (int k = 0; 2 * k <= l; ++k) {
        double a = 1.0;  // C(l, k) C(2l - 2k, l) / 2^l, exact in double for l <= 8
        for (int i = 1; i <= k; ++i) a = a * (l - k + i) / i;
        double b = 1.0;
        for (int i = 1; i <= l; ++i) b = b * (l - 2 * k + i) / i;
        a = a * b / (double)(1 << l);
        c[(l - 2 * k) / 2] = (float)((k % 2) ? -a : a);
    }
    return true;
}

}  // namespace

// ---- host entries ----

// Resident blocks an SM holds of the (nfields, npoles) instance at `warps`
// warps a block and `smem` bytes of dynamic shared memory, on device `dev`
// (the current device).
extern "C" int mode_bin_pairs_occupancy(int nfields, int npoles, int warps, int smem, int dev,
                                        int* blocks_per_sm) {
    KernelFn fn = nullptr;
    cudaError_t e = prepared(nfields, npoles, dev, &fn);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, (const void*)fn,
                                                              32 * warps, (size_t)smem);
}

// Launch the binning of `nfields` meshes (an array of pointers, read through
// the element strides sx, sy, sz they share) over the non-empty groups of
// four rows `groups` with each row's kz span (`bounds`, [lo, hi) a row), then
// the reduction of the `blocks` partials (scratch of blocks x H floats) into
// `out`: H = npairs x (nbins + npoles x nbins / nmu) doubles, or floats when
// out_f64 is 0. The meshes, seg and the row spans hold the ny rows of the ky
// slab that starts at global row y0 (ny = n1d, y0 = 0: the whole mesh).
// Group ids count the slab's rows: ix * ceil(ny / 4) + iy / 4 (four rows
// along y) with xgroups 0, iy * ceil(n1d / 4) + ix / 4 (along x) with 1.
extern "C" int mode_bin_pairs(const void* const* fields, int nfields, long long sx, long long sy,
                              long long sz, const int* seg, const int* groups, int ngroups,
                              const int* bounds, const float* W, float scale, int n1d, int nbins,
                              int nmu, const int* pole_degrees, int npoles, int blocks, int warps,
                              int copies, int smem, int dev, float* partials, void* out,
                              int out_f64, int ny, int y0, int xgroups, void* stream) {
    if (npoles > 0 && (nmu < 1 || nbins % nmu != 0)) return (int)cudaErrorInvalidValue;
    if (ny < 1 || y0 < 0 || y0 + ny > n1d) return (int)cudaErrorInvalidValue;
    if (blocks < 1 || warps < 1 || warps > 8 || (copies != 1 && copies != kRows)) {
        return (int)cudaErrorInvalidValue;
    }
    KernelFn fn = nullptr;
    cudaError_t e = prepared(nfields, npoles, dev, &fn);
    if (e != cudaSuccess) return (int)e;
    Fields f = {};
    for (int t = 0; t < nfields; ++t) f.p[t] = (const float2*)fields[t];
    Poles poles = {};
    for (int q = 0; q < npoles; ++q) {
        const int l = pole_degrees[q];
        if (!legendre(l, poles.c[q])) return (int)cudaErrorInvalidValue;
        poles.norm[q] = (float)(2 * l + 1);
        poles.odd[q] = l % 2;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    void* args[] = {&f,     &sx,  &sy,    &sz,  &seg,   &groups,   &ngroups, &bounds, &W,
                    &scale, &n1d, &nbins, &nmu, &poles, &copies, &partials, &ny,     &y0,
                    &xgroups};
    e = cudaLaunchKernel((const void*)fn, dim3(blocks), dim3(32 * warps), args, (size_t)smem, s);
    if (e != cudaSuccess) return (int)e;
    const int npairs = nfields * (nfields + 1) / 2;
    const int H = npairs * (nbins + npoles * (npoles > 0 ? nbins / nmu : 0));
    const dim3 grid((H + 31) / 32), block(kReduceWarps * 32);
    if (out_f64) {
        mode_bin_reduce_kernel<double><<<grid, block, 0, s>>>(partials, blocks, H, (double*)out);
    } else {
        mode_bin_reduce_kernel<float><<<grid, block, 0, s>>>(partials, blocks, H, (float*)out);
    }
    return (int)cudaGetLastError();
}
