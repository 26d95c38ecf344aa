// K4 and K5: exact DD pair counts on a periodic box, in (rp, pi) or (s, mu) bins.
//
// Replace the TPU pair-count programs of abacusutils_tpu/ops/tpcf.py:
// K4 (pair_count_cells) stands for _combo_counts + _hist2d_cum, the cell-grid
// engine, and K5 (pair_count_all) for _count_rppi / _count_smu, the tiled
// all-pairs engine. On the TPU the histogram of a block of candidate pairs was
// a product of two cumulative one-hot matrices on the MXU, fed from padded
// power-of-two occupancy classes. Here the points stay in the order of one
// stable sort by cell (ops/tpcf.py:stage_cells); the kernel reads the sorted
// columns, the per-cell starts of the second side and a work list of
// (cell, begin, end) items of at most 64 points of the first side.
//
// K4, one block a work item:
//   1. the item's na <= 64 points sit in registers, one a thread, repeated over
//      TB = 128 / TA thread groups, TA the power of two >= na (at least 4): a
//      sparse cell's few points each get many lanes, a full chunk two;
//   2. the block walks the 27 neighbour cells (the centre and the 13
//      lexicographically positive ones for an autocorrelation, whose counts are
//      doubled), finds each from the cell index with its per-axis wrap, and
//      streams its points through a shared tile of 128 float4;
//   3. a thread evaluates its point against every TB-th tile entry: the
//      differences, the item-constant minimum image (nc >= 5: subtract w * lbox,
//      w in {-1, 0, 1}; nc of 3 or 4: the per-pair d - lbox * rint(d / lbox)),
//      r2, and rejects the pair unless edges2[0] <= r2 < edges2[nb1] (and, for
//      rppi, |dz| < npi): with cells of about rmax a side three quarters of the
//      candidates end here;
//   4. a survivor's bin comes from a compare-sum over the squared edges in
//      shared memory, and one native integer atomicAdd goes to the block's
//      int32 histogram in shared memory; the block adds its non-zero bins to the
//      int64 result with atomicAdd(unsigned long long). Integer adds commute, so
//      two launches give the same bits.
//   The pair i == j of an autocorrelation's centre cell is skipped by index.
//
// K5, one block a tile of 128 rows of the first set and a range of the second:
// the same binning on all pairs, with the per-pair minimum image, in float or
// double (the JAX tiled engine computes in double under x64).
//
// What bounds them on the H100: operations. A candidate pair of K4's rppi form
// costs 6 subtractions, 2 products, 1 sum and 3 compares, 12 f32 operations,
// against 16 bytes of tile traffic from shared memory and none from device
// memory beyond each point read once a neighbour walk; the design keeps every
// lane on a pair (the TA x TB layout), ends three quarters of the pairs at the
// reject test and adds integers natively.
//
// Every product, sum, difference, quotient and root of the pair arithmetic is
// an _rn intrinsic, so nvcc cannot contract a product and a sum into an FMA:
// dx*dx + dy*dy rounds as the JAX package's f32 program and a numpy brute
// force round it, and no pair changes its bin.

#include <cuda_runtime.h>

namespace {

constexpr int K4_THREADS = 128;
constexpr int K5_THREADS = 128;
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
};

// d - lbox * round(d / lbox), round half to even (abacusutils_tpu/ops/tpcf.py:_min_image)
template <typename T>
__device__ __forceinline__ T min_image(T d, T lbox) {
    return Ar<T>::sub(d, Ar<T>::mul(lbox, Ar<T>::rint(Ar<T>::div(d, lbox))));
}

// The flat bin nb2 * b1 + b2 of a pair with minimum-image differences dx, dy
// and adz = |dz|, or -1 where it falls outside every bin. b1 counts the squared
// edges that r2 has reached (right-open bins); b2 is floor(adz) below nb2
// (rppi), or min(int(mu * aux), nb2 - 1) with mu = adz / s, 0 where s = 0 (smu).
template <typename T, int MODE>
__device__ __forceinline__ int pair_bin(T dx, T dy, T adz, const T* __restrict__ edges, int nb1,
                                        int nb2, T aux) {
    typedef Ar<T> A;
    int b2;
    if (MODE == MODE_RPPI) {
        if (!(adz < (T)nb2)) return -1;
    }
    T r2 = A::add(A::mul(dx, dx), A::mul(dy, dy));
    if (MODE == MODE_SMU) r2 = A::add(r2, A::mul(adz, adz));
    if (!(r2 >= edges[0]) || r2 >= edges[nb1]) return -1;
    if (MODE == MODE_RPPI) {
        b2 = (int)adz;
    } else {
        const T s = A::sqrt(r2);
        const T mu = s > (T)0 ? A::div(adz, s) : (T)0;
        b2 = min((int)A::mul(mu, aux), nb2 - 1);
    }
    int b1 = 0;
    for (int k = 1; k < nb1; ++k) b1 += r2 >= edges[k];
    return b1 * nb2 + b2;
}

__device__ __forceinline__ void flush_hist(const int* hist, int nbins, int threads,
                                           unsigned long long* out) {
    for (int b = threadIdx.x; b < nbins; b += threads) {
        const int v = hist[b];
        if (v) atomicAdd(&out[b], (unsigned long long)v);
    }
}

// ---- K4 ---------------------------------------------------------------------

// shared memory: the float4 tile, the squared edges, the int32 histogram
__host__ __device__ inline size_t k4_smem(int nb1, int nb2) {
    return sizeof(float4) * K4_THREADS + sizeof(float) * (nb1 + 1) + sizeof(int) * nb1 * nb2;
}

template <int MODE, bool WRAP>
__global__ void __launch_bounds__(K4_THREADS)
pair_count_cells_kernel(const float* __restrict__ ax, const float* __restrict__ ay,
                        const float* __restrict__ az, const float* __restrict__ bx,
                        const float* __restrict__ by, const float* __restrict__ bz,
                        const int* __restrict__ starts_b, const int* __restrict__ work, int nc,
                        float lbox, const float* __restrict__ edges2, int nb1, int nb2, float aux,
                        int autocorr, unsigned long long* __restrict__ out) {
    const int item = blockIdx.x;
    const int cell = work[3 * item], begin = work[3 * item + 1], end = work[3 * item + 2];
    const int na = end - begin;
    if (na <= 0) return;

    extern __shared__ float4 smem4[];
    float4* tile = smem4;
    float* edges = reinterpret_cast<float*>(tile + K4_THREADS);
    int* hist = reinterpret_cast<int*>(edges + nb1 + 1);
    const int nbins = nb1 * nb2;
    const int t = threadIdx.x;
    for (int b = t; b < nbins; b += K4_THREADS) hist[b] = 0;
    for (int k = t; k <= nb1; k += K4_THREADS) edges[k] = edges2[k];

    // TA lanes along the item's points, TB = K4_THREADS / TA along the tile
    int la = 2;
    while ((1 << la) < na) ++la;
    const int ta = t & ((1 << la) - 1);
    const int tb = t >> la;
    const int TB = K4_THREADS >> la;
    const bool active = ta < na;
    const int ia = begin + ta;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (active) {
        px = ax[ia];
        py = ay[ia];
        pz = az[ia];
    }
    const int ci = cell / (nc * nc), cj = (cell / nc) % nc, ck = cell % nc;

    // offsets in lexicographic order of (di, dj, dk); 13 is the centre
    for (int o = autocorr ? 13 : 0; o < 27; ++o) {
        int ni = ci + o / 9 - 1, nj = cj + (o / 3) % 3 - 1, nk = ck + o % 3 - 1;
        // a neighbour past an edge: the minimum image adds -+lbox
        const int wi = ni < 0 ? -1 : (ni >= nc ? 1 : 0);
        const int wj = nj < 0 ? -1 : (nj >= nc ? 1 : 0);
        const int wk = nk < 0 ? -1 : (nk >= nc ? 1 : 0);
        ni -= wi * nc;
        nj -= wj * nc;
        nk -= wk * nc;
        const int ncell = (ni * nc + nj) * nc + nk;
        const int sb = starts_b[ncell], eb = starts_b[ncell + 1];
        if (sb == eb) continue;
        const float wx = (float)wi * lbox, wy = (float)wj * lbox, wz = (float)wk * lbox;
        const bool centre = autocorr && o == 13;
        const int mult = (autocorr && o != 13) ? 2 : 1;
        for (int j0 = sb; j0 < eb; j0 += K4_THREADS) {
            const int jn = min(K4_THREADS, eb - j0);
            __syncthreads();
            if (t < jn) tile[t] = make_float4(bx[j0 + t], by[j0 + t], bz[j0 + t], 0.f);
            __syncthreads();
            if (!active) continue;
#pragma unroll 2
            for (int j = tb; j < jn; j += TB) {
                const float4 q = tile[j];
                if (centre && j0 + j == ia) continue;
                float dx = __fsub_rn(px, q.x), dy = __fsub_rn(py, q.y), dz = __fsub_rn(pz, q.z);
                if (WRAP) {
                    dx = __fsub_rn(dx, wx);
                    dy = __fsub_rn(dy, wy);
                    dz = __fsub_rn(dz, wz);
                } else {
                    dx = min_image(dx, lbox);
                    dy = min_image(dy, lbox);
                    dz = min_image(dz, lbox);
                }
                const int bin = pair_bin<float, MODE>(dx, dy, fabsf(dz), edges, nb1, nb2, aux);
                if (bin >= 0) atomicAdd(&hist[bin], mult);
            }
        }
    }
    __syncthreads();
    flush_hist(hist, nbins, K4_THREADS, out);
}

template <int MODE, bool WRAP>
cudaError_t launch_cells(const float* ax, const float* ay, const float* az, const float* bx,
                         const float* by, const float* bz, const int* starts_b, const int* work,
                         int nitems, int nc, float lbox, const float* edges2, int nb1, int nb2,
                         float aux, int autocorr, unsigned long long* out, cudaStream_t s) {
    const size_t smem = k4_smem(nb1, nb2);
    auto kernel = pair_count_cells_kernel<MODE, WRAP>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<nitems, K4_THREADS, smem, s>>>(ax, ay, az, bx, by, bz, starts_b, work, nc, lbox,
                                            edges2, nb1, nb2, aux, autocorr, out);
    return cudaGetLastError();
}

// ---- K5 ---------------------------------------------------------------------

template <typename T>
__host__ __device__ inline size_t k5_smem(int nb1, int nb2) {
    return sizeof(T) * (3 * K5_THREADS + nb1 + 1) + sizeof(int) * nb1 * nb2;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(K5_THREADS)
pair_count_all_kernel(const T* __restrict__ x1, const T* __restrict__ y1, const T* __restrict__ z1,
                      int n1, const T* __restrict__ x2, const T* __restrict__ y2,
                      const T* __restrict__ z2, int n2, int jchunk, T lbox,
                      const T* __restrict__ edges2, int nb1, int nb2, T aux, int autocorr,
                      unsigned long long* __restrict__ out) {
    extern __shared__ double smem8[];
    T* tx = reinterpret_cast<T*>(smem8);
    T* ty = tx + K5_THREADS;
    T* tz = ty + K5_THREADS;
    T* edges = tz + K5_THREADS;
    int* hist = reinterpret_cast<int*>(edges + nb1 + 1);
    const int nbins = nb1 * nb2;
    const int t = threadIdx.x;
    for (int b = t; b < nbins; b += K5_THREADS) hist[b] = 0;
    for (int k = t; k <= nb1; k += K5_THREADS) edges[k] = edges2[k];

    const int i = blockIdx.x * K5_THREADS + t;
    const bool active = i < n1;
    T px = 0, py = 0, pz = 0;
    if (active) {
        px = x1[i];
        py = y1[i];
        pz = z1[i];
    }
    const int jbegin = blockIdx.y * jchunk;
    const int jend = min(n2, jbegin + jchunk);
    for (int j0 = jbegin; j0 < jend; j0 += K5_THREADS) {
        const int jn = min(K5_THREADS, jend - j0);
        __syncthreads();
        if (t < jn) {
            tx[t] = x2[j0 + t];
            ty[t] = y2[j0 + t];
            tz[t] = z2[j0 + t];
        }
        __syncthreads();
        if (!active) continue;
#pragma unroll 2
        for (int j = 0; j < jn; ++j) {
            if (autocorr && j0 + j == i) continue;
            const T dx = min_image(Ar<T>::sub(px, tx[j]), lbox);
            const T dy = min_image(Ar<T>::sub(py, ty[j]), lbox);
            const T dz = min_image(Ar<T>::sub(pz, tz[j]), lbox);
            const int bin = pair_bin<T, MODE>(dx, dy, Ar<T>::abs(dz), edges, nb1, nb2, aux);
            if (bin >= 0) atomicAdd(&hist[bin], 1);
        }
    }
    __syncthreads();
    flush_hist(hist, nbins, K5_THREADS, out);
}

template <typename T, int MODE>
cudaError_t launch_all(const void* x1, const void* y1, const void* z1, int n1, const void* x2,
                       const void* y2, const void* z2, int n2, int jchunk, double lbox,
                       const void* edges2, int nb1, int nb2, double aux, int autocorr,
                       unsigned long long* out, cudaStream_t s) {
    const size_t smem = k5_smem<T>(nb1, nb2);
    auto kernel = pair_count_all_kernel<T, MODE>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((n1 + K5_THREADS - 1) / K5_THREADS, (n2 + jchunk - 1) / jchunk);
    kernel<<<grid, K5_THREADS, smem, s>>>(
        (const T*)x1, (const T*)y1, (const T*)z1, n1, (const T*)x2, (const T*)y2, (const T*)z2, n2,
        jchunk, (T)lbox, (const T*)edges2, nb1, nb2, (T)aux, autocorr, out);
    return cudaGetLastError();
}

}  // namespace

// K4: add the pair counts of `nitems` work items (rows of `work`: cell, begin,
// end into the first side's sorted columns) against the second side's cells
// into out[nb1 * nb2]. mode 0 is rppi, 1 is smu; use_wrap picks the
// item-constant minimum image (nc >= 5). Returns cudaGetLastError().
extern "C" int pair_count_cells(const float* ax, const float* ay, const float* az,
                                const float* bx, const float* by, const float* bz,
                                const int* starts_b, const int* work, int nitems, int nc,
                                float lbox, const float* edges2, int nb1, int nb2, float aux,
                                int mode, int autocorr, int use_wrap, unsigned long long* out,
                                void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (nitems <= 0) return (int)cudaSuccess;
#define K4_ARGS ax, ay, az, bx, by, bz, starts_b, work, nitems, nc, lbox, edges2, nb1, nb2, aux, \
                autocorr, out, s
    switch (2 * mode + (use_wrap ? 1 : 0)) {
        case 0: return (int)launch_cells<MODE_RPPI, false>(K4_ARGS);
        case 1: return (int)launch_cells<MODE_RPPI, true>(K4_ARGS);
        case 2: return (int)launch_cells<MODE_SMU, false>(K4_ARGS);
        case 3: return (int)launch_cells<MODE_SMU, true>(K4_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K4_ARGS
}

// K5: add the counts of all n1 x n2 pairs into out[nb1 * nb2]; each block
// takes 128 rows of the first set and `jchunk` of the second. The columns and
// edges are float (is_f64 = 0) or double (1).
extern "C" int pair_count_all(const void* x1, const void* y1, const void* z1, int n1,
                              const void* x2, const void* y2, const void* z2, int n2, int jchunk,
                              double lbox, const void* edges2, int nb1, int nb2, double aux,
                              int mode, int autocorr, int is_f64, unsigned long long* out,
                              void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (n1 <= 0 || n2 <= 0) return (int)cudaSuccess;
#define K5_ARGS x1, y1, z1, n1, x2, y2, z2, n2, jchunk, lbox, edges2, nb1, nb2, aux, autocorr, out, s
    switch (2 * mode + (is_f64 ? 1 : 0)) {
        case 0: return (int)launch_all<float, MODE_RPPI>(K5_ARGS);
        case 1: return (int)launch_all<double, MODE_RPPI>(K5_ARGS);
        case 2: return (int)launch_all<float, MODE_SMU>(K5_ARGS);
        case 3: return (int)launch_all<double, MODE_SMU>(K5_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K5_ARGS
}
