// Per-ray traversal of the 8-wide BVH (accel/bvh.py layout) as XLA FFI
// custom calls: one thread walks one ray on a short local stack,
// nearest child first. Python side: pupiloptixlab_tpu/accel/cuda_bvh.py
// (build + binding); plain-JAX twin and reference:
// pupiloptixlab_tpu/accel/traverse.py::walk.
//
// Tables (row-major f32 / i32, as flattened by flatten/flatten.py):
//   tri    (T, 12)   [p0 xyz, e1 xyz, e2 xyz, pad 3]  -> 3 float4 per row
//   child  (M*8,)    >= 0 internal node, < 0 leaf code -(x + 1)
//   boxes  (M*8, 8)  [lo xyz, hi xyz, 0, 0]           -> 2 float4 per child
//   flat trees:      leaf code x is the first tri row of a tcl-row leaf
//   instanced trees: x is a world leaf: rows [leaf_start[x], +tcl) in the
//                    object space of instance leaf_inst[x] (w2o 3x4 rows)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> (accel/cuda_bvh.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStack = 64;        // == accel/traverse.py STACK_SIZE
constexpr float kDetEps = 1e-12f;
constexpr float kMaxDistance = 1e16f;
constexpr int kBlock = 128;

__device__ __forceinline__ float safe_inv(float d) {
  return (d < 0.f ? -1.f : 1.f) / fmaxf(fabsf(d), 1e-12f);
}

__device__ __forceinline__ void cswap(float &ka, int &va, float &kb, int &vb) {
  if (kb < ka) {
    float k = ka; ka = kb; kb = k;
    int v = va; va = vb; vb = v;
  }
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Moller-Trumbore, same arithmetic as traverse.py::_leaf_t; returns the
// hit distance or kMaxDistance.
__device__ __forceinline__ float tri_t(const float4 *__restrict__ r,
                                       const Ray &ray, float tmin,
                                       float tmax) {
  float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  float p0x = a.x, p0y = a.y, p0z = a.z;
  float e1x = a.w, e1y = b.x, e1z = b.y;
  float e2x = b.z, e2y = b.w, e2z = c.x;
  float pvx = ray.dy * e2z - ray.dz * e2y;
  float pvy = ray.dz * e2x - ray.dx * e2z;
  float pvz = ray.dx * e2y - ray.dy * e2x;
  float det = e1x * pvx + e1y * pvy + e1z * pvz;
  if (!(fabsf(det) >= kDetEps)) return kMaxDistance;
  float inv = 1.f / det;
  float tvx = ray.ox - p0x, tvy = ray.oy - p0y, tvz = ray.oz - p0z;
  float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  float qvx = tvy * e1z - tvz * e1y;
  float qvy = tvz * e1x - tvx * e1z;
  float qvz = tvx * e1y - tvy * e1x;
  float v = (ray.dx * qvx + ray.dy * qvy + ray.dz * qvz) * inv;
  float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  bool ok = u >= 0.f && v >= 0.f && u + v <= 1.f && t > tmin && t < tmax;
  return ok ? t : kMaxDistance;
}

template <bool kAny, bool kInst>
__global__ void __launch_bounds__(kBlock)
traverse_kernel(const float *__restrict__ rox, const float *__restrict__ roy,
                const float *__restrict__ roz, const float *__restrict__ rdx,
                const float *__restrict__ rdy, const float *__restrict__ rdz,
                const float *__restrict__ tmin_a,
                const float *__restrict__ tmax_a, int64_t n,
                const float4 *__restrict__ tri,
                const int32_t *__restrict__ child,
                const float4 *__restrict__ boxes,
                const int32_t *__restrict__ leaf_start,
                const int32_t *__restrict__ leaf_inst,
                const float *__restrict__ w2o, int tcl,
                float *__restrict__ out_t, int32_t *__restrict__ out_idx,
                int32_t *__restrict__ out_leaf) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray world = {rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i]};
  const float ix = safe_inv(world.dx), iy = safe_inv(world.dy),
              iz = safe_inv(world.dz);
  const float tmin = tmin_a[i];
  float best = tmax_a[i];
  int32_t best_i = -1, best_l = -1;
  bool occ = false;

  int32_t stack[kStack];
  float stack_t[kStack];
  int sp = 0;
  if (best > tmin) {
    stack[0] = 0;
    stack_t[0] = tmin;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    const int32_t e = stack[sp];
    if (!(stack_t[sp] < best)) continue;
    if (e >= 0) {
      float key[8];
      int32_t id[8];
      const float4 *b = boxes + (int64_t)e * 16;
      const int32_t *c = child + (int64_t)e * 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float4 lo = __ldg(b + 2 * k), hi = __ldg(b + 2 * k + 1);
        float tx0 = (lo.x - world.ox) * ix, tx1 = (lo.w - world.ox) * ix;
        float ty0 = (lo.y - world.oy) * iy, ty1 = (hi.x - world.oy) * iy;
        float tz0 = (lo.z - world.oz) * iz, tz1 = (hi.y - world.oz) * iz;
        float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fmaxf(fminf(tz0, tz1), tmin));
        float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fminf(fmaxf(tz0, tz1), best));
        key[k] = tn <= tf ? tn : INFINITY;
        id[k] = __ldg(c + k);
      }
      if (!kAny) {
        // 19-comparator sorting network: nearest child ends on top
        cswap(key[0], id[0], key[1], id[1]); cswap(key[2], id[2], key[3], id[3]);
        cswap(key[4], id[4], key[5], id[5]); cswap(key[6], id[6], key[7], id[7]);
        cswap(key[0], id[0], key[2], id[2]); cswap(key[1], id[1], key[3], id[3]);
        cswap(key[4], id[4], key[6], id[6]); cswap(key[5], id[5], key[7], id[7]);
        cswap(key[1], id[1], key[2], id[2]); cswap(key[5], id[5], key[6], id[6]);
        cswap(key[0], id[0], key[4], id[4]); cswap(key[3], id[3], key[7], id[7]);
        cswap(key[1], id[1], key[5], id[5]); cswap(key[2], id[2], key[6], id[6]);
        cswap(key[1], id[1], key[4], id[4]); cswap(key[3], id[3], key[6], id[6]);
        cswap(key[2], id[2], key[4], id[4]); cswap(key[3], id[3], key[5], id[5]);
        cswap(key[3], id[3], key[4], id[4]);
      }
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        if (key[k] < INFINITY) {
          stack[sp] = id[k];
          stack_t[sp] = key[k];
          ++sp;
        }
      }
    } else {
      const int32_t leaf = -e - 1;
      Ray ray = world;
      int32_t start = leaf;
      if (kInst) {
        start = __ldg(leaf_start + leaf);
        const float *w = w2o + 12 * (int64_t)__ldg(leaf_inst + leaf);
        ray.ox = w[0] * world.ox + w[1] * world.oy + w[2] * world.oz + w[3];
        ray.oy = w[4] * world.ox + w[5] * world.oy + w[6] * world.oz + w[7];
        ray.oz = w[8] * world.ox + w[9] * world.oy + w[10] * world.oz + w[11];
        ray.dx = w[0] * world.dx + w[1] * world.dy + w[2] * world.dz;
        ray.dy = w[4] * world.dx + w[5] * world.dy + w[6] * world.dz;
        ray.dz = w[8] * world.dx + w[9] * world.dy + w[10] * world.dz;
      }
      const float4 *rows = tri + 3 * (int64_t)start;
      for (int k = 0; k < tcl; ++k) {
        float t = tri_t(rows + 3 * k, ray, tmin, best);
        if (t < best) {
          if (kAny) {
            occ = true;
            break;
          }
          best = t;
          best_i = start + k;
          best_l = leaf;
        }
      }
      if (kAny && occ) break;
    }
  }
  if (kAny) {
    out_idx[i] = occ ? 1 : 0;
  } else {
    out_t[i] = best_i >= 0 ? best : kMaxDistance;
    out_idx[i] = best_i;
    out_leaf[i] = best_l;
  }
}

template <bool kAny>
ffi::Error launch(cudaStream_t stream, ffi::Buffer<ffi::F32> rox,
                  ffi::Buffer<ffi::F32> roy, ffi::Buffer<ffi::F32> roz,
                  ffi::Buffer<ffi::F32> rdx, ffi::Buffer<ffi::F32> rdy,
                  ffi::Buffer<ffi::F32> rdz, ffi::Buffer<ffi::F32> tmin,
                  ffi::Buffer<ffi::F32> tmax, ffi::Buffer<ffi::F32> tri,
                  ffi::Buffer<ffi::S32> child, ffi::Buffer<ffi::F32> boxes,
                  ffi::Buffer<ffi::S32> leaf_start,
                  ffi::Buffer<ffi::S32> leaf_inst, ffi::Buffer<ffi::F32> w2o,
                  float *out_t, int32_t *out_idx, int32_t *out_leaf,
                  int32_t tcl, int32_t instanced) {
  const int64_t n = rox.element_count();
  if (tri.element_count() % 12 != 0 || boxes.element_count() % 64 != 0 ||
      child.element_count() * 8 != boxes.element_count()) {
    return ffi::Error::InvalidArgument("bvh traversal: bad table shapes");
  }
  if (n == 0) return ffi::Error::Success();
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock));
  const auto *tri4 = reinterpret_cast<const float4 *>(tri.typed_data());
  const auto *box4 = reinterpret_cast<const float4 *>(boxes.typed_data());
#define PUPIL_TRAVERSE_ARGS                                                   \
  rox.typed_data(), roy.typed_data(), roz.typed_data(), rdx.typed_data(),     \
      rdy.typed_data(), rdz.typed_data(), tmin.typed_data(),                  \
      tmax.typed_data(), n, tri4, child.typed_data(), box4,                   \
      leaf_start.typed_data(), leaf_inst.typed_data(), w2o.typed_data(), tcl, \
      out_t, out_idx, out_leaf
  if (instanced) {
    traverse_kernel<kAny, true><<<grid, kBlock, 0, stream>>>(PUPIL_TRAVERSE_ARGS);
  } else {
    traverse_kernel<kAny, false><<<grid, kBlock, 0, stream>>>(PUPIL_TRAVERSE_ARGS);
  }
#undef PUPIL_TRAVERSE_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error closest_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> rox,
                        ffi::Buffer<ffi::F32> roy, ffi::Buffer<ffi::F32> roz,
                        ffi::Buffer<ffi::F32> rdx, ffi::Buffer<ffi::F32> rdy,
                        ffi::Buffer<ffi::F32> rdz, ffi::Buffer<ffi::F32> tmin,
                        ffi::Buffer<ffi::F32> tmax, ffi::Buffer<ffi::F32> tri,
                        ffi::Buffer<ffi::S32> child,
                        ffi::Buffer<ffi::F32> boxes,
                        ffi::Buffer<ffi::S32> leaf_start,
                        ffi::Buffer<ffi::S32> leaf_inst,
                        ffi::Buffer<ffi::F32> w2o,
                        ffi::ResultBuffer<ffi::F32> t,
                        ffi::ResultBuffer<ffi::S32> idx,
                        ffi::ResultBuffer<ffi::S32> leaf, int32_t tcl,
                        int32_t instanced) {
  return launch<false>(stream, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri,
                       child, boxes, leaf_start, leaf_inst, w2o,
                       t->typed_data(), idx->typed_data(),
                       leaf->typed_data(), tcl, instanced);
}

ffi::Error anyhit_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> rox,
                       ffi::Buffer<ffi::F32> roy, ffi::Buffer<ffi::F32> roz,
                       ffi::Buffer<ffi::F32> rdx, ffi::Buffer<ffi::F32> rdy,
                       ffi::Buffer<ffi::F32> rdz, ffi::Buffer<ffi::F32> tmin,
                       ffi::Buffer<ffi::F32> tmax, ffi::Buffer<ffi::F32> tri,
                       ffi::Buffer<ffi::S32> child,
                       ffi::Buffer<ffi::F32> boxes,
                       ffi::Buffer<ffi::S32> leaf_start,
                       ffi::Buffer<ffi::S32> leaf_inst,
                       ffi::Buffer<ffi::F32> w2o,
                       ffi::ResultBuffer<ffi::S32> occ, int32_t tcl,
                       int32_t instanced) {
  return launch<true>(stream, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri,
                      child, boxes, leaf_start, leaf_inst, w2o, nullptr,
                      occ->typed_data(), nullptr, tcl, instanced);
}

}  // namespace

#define PUPIL_TRAVERSE_BINDING                                                \
  ffi::Ffi::Bind()                                                            \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()                               \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::S32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()                                           \
      .Arg<ffi::Buffer<ffi::S32>>()                                           \
      .Arg<ffi::Buffer<ffi::S32>>()                                           \
      .Arg<ffi::Buffer<ffi::F32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(PupilBvhClosest, closest_impl,
                              PUPIL_TRAVERSE_BINDING
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("tcl")
                                  .Attr<int32_t>("instanced"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(PupilBvhAnyhit, anyhit_impl,
                              PUPIL_TRAVERSE_BINDING
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("tcl")
                                  .Attr<int32_t>("instanced"));
