// Host-side native kernels for the data pipeline.
//
// The reference's input pipeline leans on native code for its hot loops —
// spconv's C++ VoxelGenerator (second/builder/voxel_builder.py:23-27) and
// numba-compiled geometry (points_in_rbbox via geometry.py). This library
// provides the same operations as a plain C ABI consumed via ctypes
// (second_tpu/runtime/__init__.py), with the numpy implementations in
// second_tpu/core as behavioral oracles.
//
// Build: make -C second_tpu/runtime/native   (g++ -O3, no dependencies)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// First-come voxelization (matches core/voxelize_np.points_to_voxel):
//   points      [num_points, num_features] float32, xyz leading
//   voxels      [max_voxels, max_points_per_voxel, num_features] (out, zeroed)
//   coords      [max_voxels, 3] int32 zyx (out)
//   num_points_per_voxel [max_voxels] int32 (out, zeroed)
// returns the number of voxels produced.
int64_t points_to_voxel(const float* points, int64_t num_points,
                        int64_t num_features, const float* voxel_size,
                        const float* pc_range, int64_t max_points_per_voxel,
                        int64_t max_voxels, float* voxels, int32_t* coords,
                        int32_t* num_points_per_voxel) {
  int64_t grid[3];
  for (int i = 0; i < 3; ++i) {
    grid[i] = static_cast<int64_t>(
        std::llround((pc_range[i + 3] - pc_range[i]) / voxel_size[i]));
  }
  std::unordered_map<int64_t, int64_t> voxel_of;
  voxel_of.reserve(static_cast<size_t>(max_voxels) * 2);
  int64_t num_voxels = 0;
  for (int64_t p = 0; p < num_points; ++p) {
    const float* pt = points + p * num_features;
    int64_t c[3];
    bool ok = true;
    for (int i = 0; i < 3; ++i) {
      c[i] = static_cast<int64_t>(
          std::floor((pt[i] - pc_range[i]) / voxel_size[i]));
      if (c[i] < 0 || c[i] >= grid[i]) { ok = false; break; }
    }
    if (!ok) continue;
    int64_t key = (c[2] * grid[1] + c[1]) * grid[0] + c[0];
    auto it = voxel_of.find(key);
    int64_t v;
    if (it == voxel_of.end()) {
      if (num_voxels >= max_voxels) continue;
      v = num_voxels++;
      voxel_of.emplace(key, v);
      coords[v * 3 + 0] = static_cast<int32_t>(c[2]);  // zyx
      coords[v * 3 + 1] = static_cast<int32_t>(c[1]);
      coords[v * 3 + 2] = static_cast<int32_t>(c[0]);
    } else {
      v = it->second;
    }
    int32_t& n = num_points_per_voxel[v];
    if (n < max_points_per_voxel) {
      std::memcpy(voxels + (v * max_points_per_voxel + n) * num_features,
                  pt, sizeof(float) * num_features);
      ++n;
    }
  }
  return num_voxels;
}

// Point-in-rotated-BEV-box membership with z-extent check
// (matches core/box_np.points_in_rbbox for lidar boxes [x,y,z,w,l,h,yaw],
// bottom-anchored z). out: [num_points, num_boxes] uint8.
void points_in_rbbox(const float* points, int64_t num_points,
                     int64_t num_features, const float* boxes,
                     int64_t num_boxes, uint8_t* out) {
  std::vector<float> cx(num_boxes), cy(num_boxes), cz(num_boxes);
  std::vector<float> hw(num_boxes), hl(num_boxes), hh(num_boxes);
  std::vector<float> cs(num_boxes), sn(num_boxes);
  for (int64_t b = 0; b < num_boxes; ++b) {
    const float* bx = boxes + b * 7;
    cx[b] = bx[0]; cy[b] = bx[1];
    hw[b] = bx[3] * 0.5f; hl[b] = bx[4] * 0.5f; hh[b] = bx[5] * 0.5f;
    cz[b] = bx[2] + hh[b];
    cs[b] = std::cos(bx[6]); sn[b] = std::sin(bx[6]);
  }
  for (int64_t p = 0; p < num_points; ++p) {
    const float* pt = points + p * num_features;
    uint8_t* row = out + p * num_boxes;
    for (int64_t b = 0; b < num_boxes; ++b) {
      float dx = pt[0] - cx[b];
      float dy = pt[1] - cy[b];
      float dz = pt[2] - cz[b];
      // inverse of p_world = p_box @ [[c,-s],[s,c]]
      float u = dx * cs[b] - dy * sn[b];
      float v = dx * sn[b] + dy * cs[b];
      row[b] = (std::fabs(u) <= hw[b] && std::fabs(v) <= hl[b] &&
                std::fabs(dz) <= hh[b]) ? 1 : 0;
    }
  }
}

// Pairwise BEV collision test for [*, 5(x, y, w, l, yaw)] boxes via
// separating-axis theorem on the two boxes' edge normals. out: [n1, n2] u8.
static inline void box_axes(const float* b, float ax[2][2]) {
  float c = std::cos(b[4]), s = std::sin(b[4]);
  // local +x and +y in world frame (rows of [[c,-s],[s,c]])
  ax[0][0] = c;  ax[0][1] = -s;
  ax[1][0] = s;  ax[1][1] = c;
}

static bool sat_overlap(const float* b1, const float* b2) {
  float axes1[2][2], axes2[2][2];
  box_axes(b1, axes1);
  box_axes(b2, axes2);
  float dx = b2[0] - b1[0], dy = b2[1] - b1[1];
  float h1[2] = {b1[2] * 0.5f, b1[3] * 0.5f};
  float h2[2] = {b2[2] * 0.5f, b2[3] * 0.5f};
  const float (*sets[2])[2] = {axes1, axes2};
  for (int s = 0; s < 2; ++s) {
    for (int a = 0; a < 2; ++a) {
      const float* axis = sets[s][a];
      float center_d = std::fabs(dx * axis[0] + dy * axis[1]);
      float r1 = h1[0] * std::fabs(axes1[0][0] * axis[0] +
                                   axes1[0][1] * axis[1]) +
                 h1[1] * std::fabs(axes1[1][0] * axis[0] +
                                   axes1[1][1] * axis[1]);
      float r2 = h2[0] * std::fabs(axes2[0][0] * axis[0] +
                                   axes2[0][1] * axis[1]) +
                 h2[1] * std::fabs(axes2[1][0] * axis[0] +
                                   axes2[1][1] * axis[1]);
      if (center_d > r1 + r2) return false;
    }
  }
  return true;
}

void box_collision_test(const float* boxes1, int64_t n1, const float* boxes2,
                        int64_t n2, uint8_t* out) {
  for (int64_t i = 0; i < n1; ++i) {
    for (int64_t j = 0; j < n2; ++j) {
      out[i * n2 + j] = sat_overlap(boxes1 + i * 5, boxes2 + j * 5) ? 1 : 0;
    }
  }
}

// Pairwise IoU of [N, 4] x [K, 4] xyxy boxes (matches core/box_np.iou_matrix
// with eps=0) — the anchors-vs-gt similarity matrix dominating host
// target-assignment time (~70k anchors x few gt per frame). A tight loop
// with the small K in the inner position avoids numpy's [N, K, 2]
// temporaries (~15x faster on the prep path).
void iou_matrix(const float* boxes, int64_t n, const float* query, int64_t k,
                float* out) {
  // queries unpacked to SoA so the inner loop reads contiguous lanes and
  // auto-vectorizes (the AoS form ran at scalar speed)
  std::vector<float> qx0(k), qy0(k), qx1(k), qy1(k), qa(k);
  for (int64_t j = 0; j < k; ++j) {
    const float* q = query + j * 4;
    qx0[j] = q[0]; qy0[j] = q[1]; qx1[j] = q[2]; qy1[j] = q[3];
    qa[j] = (q[2] - q[0]) * (q[3] - q[1]);
  }
  const float* px0 = qx0.data();
  const float* py0 = qy0.data();
  const float* px1 = qx1.data();
  const float* py1 = qy1.data();
  const float* pa = qa.data();
  for (int64_t i = 0; i < n; ++i) {
    const float bx0 = boxes[i * 4], by0 = boxes[i * 4 + 1];
    const float bx1 = boxes[i * 4 + 2], by1 = boxes[i * 4 + 3];
    const float area = (bx1 - bx0) * (by1 - by0);
    float* row = out + i * k;
    for (int64_t j = 0; j < k; ++j) {  // branchless
      const float w = std::fmax(std::fmin(bx1, px1[j]) -
                                std::fmax(bx0, px0[j]), 0.0f);
      const float h = std::fmax(std::fmin(by1, py1[j]) -
                                std::fmax(by0, py0[j]), 0.0f);
      const float inter = w * h;
      row[j] = inter / std::fmax(area + pa[j] - inter, 1e-30f);
    }
  }
}

}  // extern "C"
