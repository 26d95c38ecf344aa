// K1: TSC or CIC deposit of brick-sorted weighted points into a periodic nmesh^3 grid.
//
// Replaces the TPU deposit abacusutils_tpu/ops/grid_pallas.py:_deposit_kernel
// (and its XLA twins ops/grid.py:paint_grouped_yb_multi + fold_ypad and, for
// CIC, ops/grid.py:_paint_3d_jit). On the TPU a cell's deposit was a one-hot
// matrix product on the MXU, fed from a padded (ncell, K) layout. Here the
// points stay in the order of one stable sort by the 3-D brick of their cell
// (ops/grid.py:stage_bricks), and each thread block takes one work item, a
// brick or a chunk of at most max_points of its points:
//
//   1. zero a shared-memory tile of the brick's bx x by x bz cells, one ghost
//      layer on each side and a margin of m cells per axis for points that
//      moved after staging: (bx+2+2mx) x (by+2+2my) x (bz+2+2mz) f32, 23,328 B
//      for a 16^3 brick without margin, 28,512 B with mz = 2;
//   2. each thread takes a contiguous run of the item's points and adds the
//      27 stencil weights with shared-memory atomics; a point whose stencil
//      leaves the tile (it moved more than the margin, or was staged with
//      other arithmetic) adds its 27 weights straight into the grid with
//      global atomics and is counted in *overflow, so any displacement is
//      right and a large one only costs speed;
//   3. flush the tile's non-zero entries with V-wide global atomics (float4
//      where 4 divides nmesh, float2 where 2 does, else float) on the aligned
//      groups of grid cells each tile row overlaps, wrapping every axis
//      periodically, so no ghost fold pass is needed.
//
// What bounds it on the H100: the bytes are few (the weight of every point,
// x, y, z of the kept ones, each grid written once: 0.14 ms at 3.35 TB/s for
// the bench step's 6e7 points), so the atomics are the limit: 27 shared adds
// per kept point, which sm_90a compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS: there is no native shared f32 add), and one
// global add
// (REDG.E.ADD.F32) per flushed group. The design keeps the global flush near
// 1.4 x the grid (the ghost layers; a tile of a whole z row, as a
// (x-cell, y-block) tile would be, flushes 3-6 x the grid and at nmesh = 550
// allows only two-row blocks); sizes the tile for four or more blocks an
// SM; takes any nmesh (the last brick of an axis is ragged); cuts heavy
// bricks into several items, so one dense region does not leave a block
// running alone at the end; and spreads the lanes of a warp over points far
// apart in the sorted order, so satellites of one halo, adjacent in a
// catalog ordered by host, do not contend for one address in the CAS loop.
//
// The cell index uses the _rn intrinsics at every step so nvcc cannot contract
// it into an FMA: it is then the staging key's cell bit for bit, and points
// leave their tile only when they moved.
//
// Slab mode (SLAB, a template parameter) writes an x-slab of a sharded grid,
// the counterpart of parallel/fft.py:paint_slab and of paint_grouped_yb_multi's
// slab_x0 addressing: the destination is nx planes (nx, nmesh, nmesh) whose
// plane 0 is global plane x0 - h, the core the xl = nx - 2h planes from x0.
// It wraps in y and z; in x it takes no wrap, only the image of each stencil
// centre nearest the core's middle, ((ix - x0 + s) mod nmesh) - s + h with
// s = (nmesh - xl) / 2 (ops/grid.py:slab_plane). The bricks tile the slab's
// planes (ops/grid.py:brick_key with slab=). A point whose cloud leaves the
// nx planes adds nothing and is counted in *fault: the caller raises,
// nothing wraps silently.
//
// K1's multi-weight form (the ZCV advection's five weight columns on one
// point set) is a separate kernel, a gather without atomics:
// csrc/tsc_gather.cu.
//
// KIND (a template parameter) is 0 for TSC and 1 for CIC. CIC uses the same
// 3-point stencil and tile (weights max(d,0), 1-|d|, max(-d,0), as
// abacusutils_tpu/ops/grid.py:_cloud_weights_cic). `wrap` (an argument) says
// whether a coordinate is first wrapped once into [0, box): the JAX
// package's TSC does so by default, its CIC does not, and tsc_parallel's
// wrap=False paints TSC unwrapped; an unwrapped cell is floor((p + offset)
// * inv_h + 0.5) of the raw coordinate, taken modulo nmesh.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// the brick layout of a stage (ops/grid.py:BrickPlan)
struct Bricks {
    int nmesh;
    int bx, by, bz;  // brick interior, cells
    int nby, nbz;    // bricks along y and z
    int mx, my, mz;  // margins, cells
};

// the slab of slab mode: nx planes, plane 0 is global plane x0 - h; s is
// (nmesh - (nx - 2h)) / 2, the reach of the centres' minimum image
struct Slab {
    int nx, x0, h, s;
};

__device__ __forceinline__ int floor_mod(int i, int n) {
    const int r = i % n;
    return r < 0 ? r + n : r;
}

// One axis of the cloud, the f32 arithmetic of ops/grid.py:_axis_cloud (an
// optional single periodic wrap, then round half up). Returns the centre
// index, not yet taken modulo nmesh.
template <int KIND>
__device__ __forceinline__ int axis_cloud(float p, float box, float offset, float inv_h,
                                          bool wrap, float w[3]) {
    if (wrap) {
        if (p >= box) p = __fsub_rn(p, box);
        if (p < 0.f) p = __fadd_rn(p, box);
    }
    const float g = __fmul_rn(__fadd_rn(p, offset), inv_h);
    const float i0 = floorf(__fadd_rn(g, 0.5f));
    const float d = __fsub_rn(i0, g);
    if (KIND == 0) {
        const float a = __fadd_rn(0.5f, d);
        const float b = __fsub_rn(0.5f, d);
        w[0] = __fmul_rn(0.5f, __fmul_rn(a, a));
        w[1] = __fsub_rn(0.75f, __fmul_rn(d, d));
        w[2] = __fmul_rn(0.5f, __fmul_rn(b, b));
    } else {
        w[0] = fmaxf(d, 0.f);
        w[1] = __fsub_rn(1.f, fabsf(d));
        w[2] = fmaxf(-d, 0.f);
    }
    return (int)i0;
}

template <int KIND, int V, bool SLAB>
__global__ void __launch_bounds__(THREADS)
tsc_deposit_bricks_kernel(float* __restrict__ grid, const float* __restrict__ x,
                          const float* __restrict__ y, const float* __restrict__ z,
                          const float* __restrict__ w, const int* __restrict__ work,
                          Bricks g, float box, float offset, int wrap, int* __restrict__ overflow,
                          Slab sl, int* __restrict__ fault) {
    extern __shared__ float tile[];
    const int brick = work[3 * blockIdx.x];
    const int begin = work[3 * blockIdx.x + 1];
    const int end = work[3 * blockIdx.x + 2];
    if (begin >= end) return;  // uniform across the block

    const int n = g.nmesh;
    // the unreduced grid cell of tile entry 0 along each axis (in slab mode
    // along x the slab's plane, not reduced)
    const int ox = (brick / (g.nby * g.nbz)) * g.bx - 1 - g.mx;
    const int oy = ((brick / g.nbz) % g.nby) * g.by - 1 - g.my;
    const int oz = (brick % g.nbz) * g.bz - 1 - g.mz;
    const int tx = g.bx + 2 + 2 * g.mx;
    const int ty = g.by + 2 + 2 * g.my;
    const int tz = g.bz + 2 + 2 * g.mz;
    const int tile_n = tx * ty * tz;
    for (int i = threadIdx.x; i < tile_n; i += THREADS) tile[i] = 0.f;
    __syncthreads();

    const float inv_h = __fdiv_rn((float)n, box);
    int over = 0, bad = 0;
    // each thread takes a contiguous run of the item's points, so the lanes
    // of a warp work on points far apart in the sorted order
    const int chunk = (end - begin + THREADS - 1) / THREADS;
    const int p1 = min(begin + (threadIdx.x + 1) * chunk, end);
    for (int p = begin + threadIdx.x * chunk; p < p1; ++p) {
        const float wp = w[p];
        if (wp == 0.f) continue;
        float wx[3], wy[3], wz[3];
        int ix = axis_cloud<KIND>(x[p], box, offset, inv_h, wrap, wx);
        const int iy = axis_cloud<KIND>(y[p], box, offset, inv_h, wrap, wy);
        const int iz = axis_cloud<KIND>(z[p], box, offset, inv_h, wrap, wz);
        if (SLAB) {
            // the centre's plane of the slab, minimum-imaged; a cloud that
            // leaves the slab is a fault
            ix = floor_mod(ix - sl.x0 + sl.s, n) - sl.s + sl.h;
            if (ix < 1 || ix + 1 >= sl.nx) {
                ++bad;
                continue;
            }
        }
        // tile entry of the stencil's first cell: entry t holds grid cell
        // (o + t) mod n, so any periodic image of the cell will do (in slab
        // mode the slab's plane o + t along x)
        const int lx = SLAB ? ix - 1 - ox : floor_mod(ix - 1 - ox, n);
        const int ly = floor_mod(iy - 1 - oy, n);
        const int lz = floor_mod(iz - 1 - oz, n);
        if (lx >= 0 && lx + 2 < tx && ly + 2 < ty && lz + 2 < tz) {
            float* t0 = tile + (lx * ty + ly) * tz + lz;
            for (int a = 0; a < 3; ++a) {
                for (int b = 0; b < 3; ++b) {
                    const float wab = __fmul_rn(__fmul_rn(wx[a], wy[b]), wp);
                    float* row = t0 + (a * ty + b) * tz;
                    for (int k = 0; k < 3; ++k) atomicAdd(row + k, __fmul_rn(wab, wz[k]));
                }
            }
        } else {
            ++over;
            int gz[3];
            for (int k = 0; k < 3; ++k) gz[k] = floor_mod(iz + k - 1, n);
            for (int a = 0; a < 3; ++a) {
                const size_t gx = SLAB ? ix + a - 1 : floor_mod(ix + a - 1, n);
                for (int b = 0; b < 3; ++b) {
                    const float wab = __fmul_rn(__fmul_rn(wx[a], wy[b]), wp);
                    float* row = grid + (gx * n + floor_mod(iy + b - 1, n)) * n;
                    for (int k = 0; k < 3; ++k) atomicAdd(row + gz[k], __fmul_rn(wab, wz[k]));
                }
            }
        }
    }
    over = __reduce_add_sync(0xffffffffu, over);
    if ((threadIdx.x & 31) == 0 && over) atomicAdd(overflow, over);
    if (SLAB) {
        bad = __reduce_add_sync(0xffffffffu, bad);
        if ((threadIdx.x & 31) == 0 && bad) atomicAdd(fault, bad);
    }
    __syncthreads();

    // flush: V-wide atomics (float4, float2 or float) on the aligned groups of
    // V grid cells that each tile row overlaps; V divides nmesh, so a group
    // never straddles the wrap and a row's start is V-aligned
    const int q0 = oz >= 0 ? oz / V : -((V - 1 - oz) / V);  // floor(oz / V)
    const int nq = (oz + tz - 1 >= 0 ? (oz + tz - 1) / V : -((V - oz - tz) / V)) - q0 + 1;
    for (int i = threadIdx.x; i < tx * ty * nq; i += THREADS) {
        const int r = i / nq;
        const int g0 = (q0 + i % nq) * V;  // unreduced grid z of the group's first cell
        const float* row = tile + r * tz;
        float v[V];
        bool any = false;
        for (int c = 0; c < V; ++c) {
            const int k = g0 + c - oz;
            v[c] = (k >= 0 && k < tz) ? row[k] : 0.f;
            any |= v[c] != 0.f;
        }
        if (!any) continue;
        const int px = ox + r / ty;  // a slab's plane, or the unreduced grid x
        if (SLAB && (px < 0 || px >= sl.nx)) continue;  // no point writes there
        const size_t gx = SLAB ? px : floor_mod(px, n);
        const size_t gy = floor_mod(oy + r % ty, n);
        float* dst = grid + (gx * n + gy) * n + floor_mod(g0, n);
        if constexpr (V == 4) {
            atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
        } else if constexpr (V == 2) {
            atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
        } else {
            atomicAdd(dst, v[0]);
        }
    }
}

template <int KIND, int V, bool SLAB>
cudaError_t launch_form(float* grid, const float* x, const float* y, const float* z,
                        const float* w, const int* work, int nitems, const Bricks& g, float box,
                        float offset, int wrap, int* overflow, const Slab& sl, int* fault,
                        cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)(g.bx + 2 + 2 * g.mx) * (g.by + 2 + 2 * g.my) *
                        (g.bz + 2 + 2 * g.mz);
    cudaError_t e = cudaFuncSetAttribute(tsc_deposit_bricks_kernel<KIND, V, SLAB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    tsc_deposit_bricks_kernel<KIND, V, SLAB><<<nitems, THREADS, smem, stream>>>(
        grid, x, y, z, w, work, g, box, offset, wrap, overflow, sl, fault);
    return cudaGetLastError();
}

// the periodic grid (sl.nx == 0) or slab mode
template <int KIND, int V>
cudaError_t launch(float* grid, const float* x, const float* y, const float* z, const float* w,
                   const int* work, int nitems, const Bricks& g, float box, float offset,
                   int wrap, int* overflow, const Slab& sl, int* fault, cudaStream_t stream) {
    if (sl.nx > 0) {
        return launch_form<KIND, V, true>(grid, x, y, z, w, work, nitems, g, box, offset, wrap,
                                          overflow, sl, fault, stream);
    }
    return launch_form<KIND, V, false>(grid, x, y, z, w, work, nitems, g, box, offset, wrap,
                                       overflow, sl, fault, stream);
}

template <int KIND, int V>
cudaError_t blocks_per_sm(int smem, int* blocks) {
    cudaError_t e = cudaFuncSetAttribute(tsc_deposit_bricks_kernel<KIND, V, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, tsc_deposit_bricks_kernel<KIND, V, false>, THREADS, smem);
}

// the widest flush group that divides nmesh
int flush_width(int nmesh) { return nmesh % 4 == 0 ? 4 : nmesh % 2 == 0 ? 2 : 1; }

// One dispatch over the instantiated (KIND, V): F is called with the
// instance's launch or occupancy function.
#define K1_DISPATCH(KIND_, NMESH_, FN_, ...)                                  \
    switch (flush_width(NMESH_)) {                                            \
        case 4: return FN_<KIND_, 4>(__VA_ARGS__);                            \
        case 2: return FN_<KIND_, 2>(__VA_ARGS__);                            \
        default: return FN_<KIND_, 1>(__VA_ARGS__);                           \
    }

template <int KIND>
cudaError_t launch_kind(int nmesh, float* grid, const float* x, const float* y, const float* z,
                        const float* w, const int* work, int nitems, const Bricks& g, float box,
                        float offset, int wrap, int* overflow, const Slab& sl, int* fault,
                        cudaStream_t stream) {
    K1_DISPATCH(KIND, nmesh, launch, grid, x, y, z, w, work, nitems, g, box, offset, wrap,
                overflow, sl, fault, stream)
}

template <int KIND>
cudaError_t blocks_kind(int nmesh, int smem, int* blocks) {
    K1_DISPATCH(KIND, nmesh, blocks_per_sm, smem, blocks)
}

}  // namespace

// ---- host entries ----

// grid: nmesh^3 f32, or in slab mode (slab_nx > 0) the slab_nx x nmesh^2
// planes whose plane 0 is global plane slab_x0 - slab_h; w: the weight
// column; kind: 0 TSC, 1 CIC; wrap: 1 wraps each coordinate once into
// [0, box); fault (slab mode): gains the points whose cloud leaves the slab
extern "C" int tsc_deposit_bricks(float* grid, const float* x, const float* y, const float* z,
                                  const float* w, const int* work, int nitems, int nmesh, int bx,
                                  int by, int bz, int mx, int my, int mz, float box, float offset,
                                  int kind, int wrap, int* overflow, int slab_nx, int slab_x0,
                                  int slab_h, int* fault, void* stream) {
    const Bricks g{nmesh, bx, by, bz, (nmesh + by - 1) / by, (nmesh + bz - 1) / bz, mx, my, mz};
    const Slab sl{slab_nx, slab_x0, slab_h, (nmesh - (slab_nx - 2 * slab_h)) / 2};
    if (slab_nx > 0 && (fault == nullptr || slab_h < 1 || slab_x0 < 0 || slab_x0 >= nmesh ||
                        slab_nx < 2 * slab_h + 1 || slab_nx > nmesh + 2 * slab_h)) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    switch (kind) {
        case 0: return (int)launch_kind<0>(nmesh, grid, x, y, z, w, work, nitems, g, box, offset,
                                           wrap, overflow, sl, fault, s);
        case 1: return (int)launch_kind<1>(nmesh, grid, x, y, z, w, work, nitems, g, box, offset,
                                           wrap, overflow, sl, fault, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Resident blocks an SM can hold for a tile of `smem` bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int tsc_deposit_blocks_per_sm(int kind, int nmesh, int smem, int* blocks) {
    switch (kind) {
        case 0: return (int)blocks_kind<0>(nmesh, smem, blocks);
        case 1: return (int)blocks_kind<1>(nmesh, smem, blocks);
        default: return (int)cudaErrorInvalidValue;
    }
}
