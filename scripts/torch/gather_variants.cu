// Two other designs of K1's multi-weight gather (csrc/tsc_gather.cu), for
// scripts/torch/k1m_k7_compare.py --variants to time beside it: the same
// stage (packed points, brick-major cell starts), the same sums in the same
// order, so the same bits.
//
// gather_cells: a thread walks its cell's 27 source cells as 27 loops (the
// gather's first form) instead of 9 loops of three cells along z.
// gather_smem: a block first copies the points of its neighbourhood (the
// (GX + 2) (GY + 2) rows of GZ + 2 cells around its brick: three contiguous
// runs a row) into shared memory and walks them there; a neighbourhood of
// more than `cap` points, or a ragged brick, reads global memory as the
// kernel does.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//          -Xcompiler -fPIC -o libgather_variants.so gather_variants.cu

#include <cuda_runtime.h>

namespace {

constexpr int GX = 8, GY = 8, GZ = 32;
constexpr int BRICK_CELLS = GX * GY * GZ;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NROWS = (GX + 2) * (GY + 2);
constexpr int SLOTS = GZ + 2;  // cells a neighbourhood row holds
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int point_floats(int nw) { return 3 + nw <= 4 ? 4 : 8; }

template <int A>
__device__ __forceinline__ float tsc_weight(float d) {
    if (A == 1) return __fsub_rn(0.75f, __fmul_rn(d, d));
    const float s = A == 0 ? __fadd_rn(0.5f, d) : __fsub_rn(0.5f, d);
    return __fmul_rn(0.5f, __fmul_rn(s, s));
}

__device__ __forceinline__ float tsc_weight_at(int slot, float d) {
    const float s = slot == 0 ? __fadd_rn(0.5f, d) : __fsub_rn(0.5f, d);
    const float side = __fmul_rn(0.5f, __fmul_rn(s, s));
    const float mid = __fsub_rn(0.75f, __fmul_rn(d, d));
    return slot == 1 ? mid : side;
}

__device__ __forceinline__ int wrap(int c, int n) { return c < 0 ? c + n : (c >= n ? c - n : c); }

// one point (V float4s at q) into the sums: slots A, B, C
template <int NF, bool UNIT, int V, int A, int B>
__device__ __forceinline__ void add_point(float (&acc)[NF], const float4* q, int slot) {
    const float4 a = q[0];
    float w[8] = {a.x, a.y, a.z, a.w};
    if constexpr (V == 2) {
        const float4 b = q[1];
        w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
    }
    const float wxy = __fmul_rn(tsc_weight<A>(w[0]), tsc_weight<B>(w[1]));
    const float wz = tsc_weight_at(slot, w[2]);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
        const float wab = (UNIT && f == 0) ? wxy : __fmul_rn(wxy, w[3 + f - UNIT]);
        acc[f] = __fadd_rn(acc[f], __fmul_rn(wab, wz));
    }
}

// the cells below, at and above along z of one source row: [a0, a1), [b0, b1), [c0, c1)
template <int NF, bool UNIT, int A, int B>
__device__ __forceinline__ void three(float (&acc)[NF], const float4* pts, int a0, int a1, int b0,
                                      int b1, int c0, int c1) {
    constexpr int V = point_floats(NF - UNIT) / 4;
    const int na = a1 - a0, nab = na + b1 - b0, total = nab + c1 - c0;
    for (int t = 0; t < total; ++t) {
        const int p = t < na ? a0 + t : (t < nab ? b0 + t - na : c0 + t - nab);
        add_point<NF, UNIT, V, A, B>(acc, pts + V * p, t < na ? 2 : (t < nab ? 1 : 0));
    }
}

struct Keys {
    int kx[3], ky[3], kz[3];
};

__device__ __forceinline__ Keys keys_of(int cx, int cy, int cz, int n, int nby, int nbz) {
    Keys k;
    const int bricks_x = nby * nbz * BRICK_CELLS;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
        int c = wrap(cx + s - 1, n);
        k.kx[s] = (c / GX) * bricks_x + (c % GX) * (GY * GZ);
        c = wrap(cy + s - 1, n);
        k.ky[s] = (c / GY) * nbz * BRICK_CELLS + (c % GY) * GZ;
        c = wrap(cz + s - 1, n);
        k.kz[s] = (c / GZ) * BRICK_CELLS + c % GZ;
    }
    return k;
}

// the kernel's walk of one cell, from global memory
template <int NF, bool UNIT>
__device__ __forceinline__ void walk_global(float (&acc)[NF], const Keys& k,
                                            const int* __restrict__ starts, const float4* pts) {
#define ROW(I, J)                                                                          \
    {                                                                                      \
        const int base = k.kx[I] + k.ky[J];                                                \
        three<NF, UNIT, 2 - I, 2 - J>(acc, pts, starts[base + k.kz[0]],                    \
                                      starts[base + k.kz[0] + 1], starts[base + k.kz[1]],  \
                                      starts[base + k.kz[1] + 1], starts[base + k.kz[2]],  \
                                      starts[base + k.kz[2] + 1]);                         \
    }
    ROW(0, 0) ROW(0, 1) ROW(0, 2) ROW(1, 0) ROW(1, 1) ROW(1, 2) ROW(2, 0) ROW(2, 1) ROW(2, 2)
#undef ROW
}

template <int NF, bool UNIT>
__global__ void __launch_bounds__(THREADS)
gather_cells(float* __restrict__ grids, size_t stride, const float4* __restrict__ pts,
             const int* __restrict__ starts, int n, int nby, int nbz) {
    constexpr int V = point_floats(NF - UNIT) / 4;
    const int brick = blockIdx.x;
    const int bx = brick / (nby * nbz), by = (brick / nbz) % nby, bz = brick % nbz;
    const int cz = bz * GZ + (threadIdx.x & 31);
    if (cz >= n) return;
    for (int r = threadIdx.x >> 5; r < GX * GY; r += WARPS) {
        const int cx = bx * GX + r / GY, cy = by * GY + r % GY;
        if (cx >= n || cy >= n) continue;
        const Keys k = keys_of(cx, cy, cz, n, nby, nbz);
        float acc[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] = 0.f;
#define CELL(I, J, K)                                                                      \
    {                                                                                      \
        const int key = k.kx[I] + k.ky[J] + k.kz[K];                                       \
        const int p1 = starts[key + 1];                                                    \
        for (int p = starts[key]; p < p1; ++p)                                             \
            add_point<NF, UNIT, V, 2 - I, 2 - J>(acc, pts + V * p, 2 - K);                 \
    }
#define ROW(I, J) CELL(I, J, 0) CELL(I, J, 1) CELL(I, J, 2)
        ROW(0, 0) ROW(0, 1) ROW(0, 2) ROW(1, 0) ROW(1, 1) ROW(1, 2) ROW(2, 0) ROW(2, 1) ROW(2, 2)
#undef ROW
#undef CELL
        const size_t cell = ((size_t)cx * n + cy) * n + cz;
#pragma unroll
        for (int f = 0; f < NF; ++f) grids[f * stride + cell] = acc[f];
    }
}

template <int NF, bool UNIT>
__global__ void __launch_bounds__(THREADS)
gather_smem(float* __restrict__ grids, size_t stride, const float4* __restrict__ pts,
            const int* __restrict__ starts, int n, int nby, int nbz, int cap) {
    constexpr int V = point_floats(NF - UNIT) / 4;
    extern __shared__ float4 tile[];  // cap points
    __shared__ int loc[NROWS][SLOTS + 1];  // row-relative first point of each slot, the end
    __shared__ int run[NROWS][3];          // global first point of the row's three runs
    __shared__ int rowbase[NROWS];
    __shared__ int total_s;
    const int brick = blockIdx.x;
    const int bx = brick / (nby * nbz), by = (brick / nbz) % nby, bz = brick % nbz;
    const int z0 = bz * GZ;
    const int t = threadIdx.x, lane = t & 31;
    const bool full = z0 + GZ <= n;
    const int bricks_x = nby * nbz * BRICK_CELLS;
    for (int i = t >> 5; i < NROWS; i += WARPS) {
        const int x = wrap(bx * GX - 1 + i / (GY + 2), n), y = wrap(by * GY - 1 + i % (GY + 2), n);
        const int kxy = (x / GX) * bricks_x + (x % GX) * (GY * GZ) + (y / GY) * nbz * BRICK_CELLS +
                        (y % GY) * GZ;
        const int zl = wrap(z0 - 1, n), zr = wrap(z0 + GZ, n);
        const int kl = kxy + (zl / GZ) * BRICK_CELLS + zl % GZ;
        const int kr = kxy + (zr / GZ) * BRICK_CELLS + zr % GZ;
        const int km = kxy + bz * BRICK_CELLS;
        const int lo = full ? starts[km + lane] : 0;
        const int len = full ? starts[km + lane + 1] - lo : 0;
        const int ll = starts[kl], nl = starts[kl + 1] - ll;
        int inc = len;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += v;
        }
        loc[i][1 + lane] = nl + inc - len;
        if (lane == 0) {
            loc[i][0] = 0;
            run[i][0] = ll;
            run[i][1] = lo;
        }
        if (lane == 31) {
            const int rl = starts[kr];
            loc[i][SLOTS - 1] = nl + inc;
            loc[i][SLOTS] = nl + inc + starts[kr + 1] - rl;
            run[i][2] = rl;
        }
    }
    __syncthreads();
    if (t < 32) {
        int carry = 0;
        for (int b0 = 0; b0 < NROWS; b0 += 32) {
            const int i = b0 + t;
            const int v = i < NROWS ? loc[i][SLOTS] : 0;
            int inc = v;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(FULL, inc, o);
                if (t >= o) inc += u;
            }
            if (i < NROWS) rowbase[i] = carry + inc - v;
            carry += __shfl_sync(FULL, inc, 31);
        }
        if (t == 0) total_s = carry;
    }
    __syncthreads();
    const bool fits = full && total_s <= cap;
    if (fits) {
        for (int i = t >> 5; i < NROWS; i += WARPS) {
            const int rb = rowbase[i];
            // slot 0, the GZ cells, slot GZ + 1: three runs one after another
            const int len[3] = {loc[i][1], loc[i][SLOTS - 1] - loc[i][1],
                                loc[i][SLOTS] - loc[i][SLOTS - 1]};
            const int dst[3] = {rb, rb + loc[i][1], rb + loc[i][SLOTS - 1]};
#pragma unroll
            for (int s = 0; s < 3; ++s)
                for (int u = lane; u < V * len[s]; u += 32)
                    tile[V * dst[s] + u] = pts[V * run[i][s] + u];
        }
    }
    __syncthreads();
    const int cz = z0 + lane;
    if (cz >= n) return;
    for (int r = t >> 5; r < GX * GY; r += WARPS) {
        const int lx = r / GY, ly = r % GY;
        const int cx = bx * GX + lx, cy = by * GY + ly;
        if (cx >= n || cy >= n) continue;
        float acc[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] = 0.f;
        if (fits) {
#define ROW(I, J)                                                                          \
    {                                                                                      \
        const int i = (lx + I) * (GY + 2) + (ly + J);                                      \
        const int rb = rowbase[i];                                                         \
        three<NF, UNIT, 2 - I, 2 - J>(acc, tile, rb + loc[i][lane], rb + loc[i][lane + 1], \
                                      rb + loc[i][lane + 1], rb + loc[i][lane + 2],        \
                                      rb + loc[i][lane + 2], rb + loc[i][lane + 3]);       \
    }
            ROW(0, 0) ROW(0, 1) ROW(0, 2) ROW(1, 0) ROW(1, 1) ROW(1, 2) ROW(2, 0) ROW(2, 1)
            ROW(2, 2)
#undef ROW
        } else {
            walk_global<NF, UNIT>(acc, keys_of(cx, cy, cz, n, nby, nbz), starts, pts);
        }
        const size_t cell = ((size_t)cx * n + cy) * n + cz;
#pragma unroll
        for (int f = 0; f < NF; ++f) grids[f * stride + cell] = acc[f];
    }
}

// variant 0: gather_cells; 1: gather_smem with `smem` bytes for `cap` points
template <int NF>
cudaError_t launch_variant(int variant, float* grids, size_t stride, const float4* pts,
                           const int* starts, int nmesh, int nby, int nbz, int nblocks, int cap,
                           size_t smem, cudaStream_t s) {
    if (variant == 0) {
        gather_cells<NF, true><<<nblocks, THREADS, 0, s>>>(grids, stride, pts, starts, nmesh, nby,
                                                          nbz);
        return cudaGetLastError();
    }
    const cudaError_t e = cudaFuncSetAttribute(
        gather_smem<NF, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    gather_smem<NF, true><<<nblocks, THREADS, smem, s>>>(grids, stride, pts, starts, nmesh, nby,
                                                        nbz, cap);
    return cudaGetLastError();
}

}  // namespace

// variant 0: gather_cells; 1: gather_smem with room for `cap` points. The
// kernel of 4 weight columns and a unit grid (the ZCV call) or of a unit
// grid alone (nw 0). Returns a cudaError_t.
extern "C" int gather_variant(int variant, float* grids, const float* points, int nw,
                              const int* starts, int nmesh, int cap, void* stream) {
    if (nw != 4 && nw != 0) return (int)cudaErrorInvalidValue;
    const int nbx = (nmesh + GX - 1) / GX, nby = (nmesh + GY - 1) / GY;
    const int nbz = (nmesh + GZ - 1) / GZ;
    const size_t stride = (size_t)nmesh * nmesh * nmesh;
    const float4* pts = reinterpret_cast<const float4*>(points);
    const size_t smem = sizeof(float4) * point_floats(nw) / 4 * (size_t)cap;
    const cudaStream_t s = (cudaStream_t)stream;
    const int nb = nbx * nby * nbz;
    return (int)(nw == 4 ? launch_variant<5>(variant, grids, stride, pts, starts, nmesh, nby, nbz,
                                             nb, cap, smem, s)
                         : launch_variant<1>(variant, grids, stride, pts, starts, nmesh, nby, nbz,
                                             nb, cap, smem, s));
}
