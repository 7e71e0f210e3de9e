// Native reader of the ASDF-pack dataset format, the PyTorch port's own
// copy of the JAX package's reader: the same C ABI, the same format, the
// same arithmetic, so a pack written by either package's packer
// (tools/pack_dataset_torch.py here) reads in both, and both builds of
// this source by one compiler with the same flags give the same batches.
// alignsdf_torch/native.py builds it with g++ at first use;
// alignsdf_torch/data/packed.py binds it.
//
// File layout (little endian):
//   magic   "ASDFPK01" (8 bytes)
//   u64     n_records
//   u64     index_offset
//   ...record blobs...
//   index: per record, 7*u64: key_off, key_len, img_off, img_len,
//          meta_off, sdf_hand_off, sdf_obj_off
//   (lengths of meta/sdf blocks are implied by their fixed headers below)
//
// Blob encodings:
//   img:  raw uint8 H*W*3 (RGB), square
//   meta: f32[4 + 61*3]  — [scale, offset(3)] + the reference's (61,3) meta
//         block (joints 21, corners 9, rest corners 9, pose 15, affine 4,
//         intrinsics 3 — reference tools/create_lmdb.py:106-115)
//   sdf:  u32 pos_num, u32 neg_num, then f32[(pos+neg) * 6]
//         rows = [xyz, sdf_self, sdf_other, label]
//
// The hot per-sample work (NaN drop, |sdf|<2 filter, split-half sampling with
// replacement, clamp-label masking — reference utils/sdf_utils.py:119-163)
// runs here in native code; python gets back fixed-shape float32 buffers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <string>
#include <thread>
#include <vector>

namespace {

struct Record {
  uint64_t key_off, key_len, img_off, img_len, meta_off, sdf_hand_off,
      sdf_obj_off;
};

struct Pack {
  int fd = -1;
  const uint8_t *data = nullptr;
  size_t size = 0;
  uint64_t n_records = 0;
  const Record *index = nullptr;
};

// Core split-half sampling (shared by the per-record entry point and the
// batch builder).  Writes samples (subsample, 5) rows [xyz, hand, obj] and
// labels (subsample,) — reference utils/sdf_utils.py:119-163 semantics.
static void sample_sdf_impl(const Pack *p, int64_t i, int hand,
                            int64_t subsample, float clamp, int filter_dist,
                            uint64_t seed, float *out_samples,
                            float *out_labels) {
  const Record &r = p->index[i];
  const uint8_t *blob = p->data + (hand ? r.sdf_hand_off : r.sdf_obj_off);
  uint32_t pos_num, neg_num;
  std::memcpy(&pos_num, blob, 4);
  std::memcpy(&neg_num, blob + 4, 4);
  const float *rows = reinterpret_cast<const float *>(blob + 8);

  auto gather_valid = [&](uint32_t begin, uint32_t end,
                          std::vector<uint32_t> *keep) {
    keep->clear();
    for (uint32_t k = begin; k < end; ++k) {
      const float *row = rows + k * 6;
      float s_self = row[3], s_other = row[4];
      if (std::isnan(s_self)) continue;
      if (filter_dist &&
          !(std::fabs(s_self) < 2.f && std::fabs(s_other) < 2.f))
        continue;
      keep->push_back(k);
    }
  };

  std::vector<uint32_t> pos_keep, neg_keep;
  gather_valid(0, pos_num, &pos_keep);
  gather_valid(pos_num, pos_num + neg_num, &neg_keep);

  std::mt19937_64 rng(seed);
  int64_t half = subsample / 2;

  auto emit = [&](const std::vector<uint32_t> &keep, int64_t count,
                  int64_t out_base) {
    std::uniform_real_distribution<double> uf(0.0, 1.0);
    for (int64_t s = 0; s < count; ++s) {
      float *out_row = out_samples + (out_base + s) * 5;
      if (keep.empty()) {
        std::memset(out_row, 0, 5 * sizeof(float));
        out_labels[out_base + s] = 0.f;
        continue;
      }
      uint32_t k =
          keep[static_cast<size_t>(uf(rng) * keep.size()) % keep.size()];
      const float *row = rows + k * 6;
      out_row[0] = row[0];
      out_row[1] = row[1];
      out_row[2] = row[2];
      if (hand) {
        out_row[3] = row[3];  // self = hand column
        out_row[4] = row[4];  // other = obj column
      } else {
        out_row[3] = row[4];  // other(=hand) column first
        out_row[4] = row[3];  // self(=obj)
      }
      out_labels[out_base + s] = row[5];
    }
  };

  emit(pos_keep, half, 0);
  emit(neg_keep, subsample - half, half);

  // clamp-label masking + obj labels forced to -1 (reference :156-161)
  for (int64_t s = 0; s < subsample; ++s) {
    float sdf_hand_col = out_samples[s * 5 + 3];
    if (clamp > 0 && (sdf_hand_col < -clamp || sdf_hand_col > clamp))
      out_labels[s] = -1.f;
    if (!hand) out_labels[s] = -1.f;
  }
}

}  // namespace

extern "C" {

void *packed_open(const char *path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void *map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t *data = static_cast<const uint8_t *>(map);
  if (st.st_size < 24 || std::memcmp(data, "ASDFPK01", 8) != 0) {
    munmap(map, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Pack *p = new Pack;
  p->fd = fd;
  p->data = data;
  p->size = st.st_size;
  std::memcpy(&p->n_records, data + 8, 8);
  uint64_t index_offset;
  std::memcpy(&index_offset, data + 16, 8);
  p->index = reinterpret_cast<const Record *>(data + index_offset);
  return p;
}

void packed_close(void *handle) {
  Pack *p = static_cast<Pack *>(handle);
  if (!p) return;
  munmap(const_cast<uint8_t *>(p->data), p->size);
  ::close(p->fd);
  delete p;
}

int64_t packed_count(void *handle) {
  return static_cast<Pack *>(handle)->n_records;
}

int64_t packed_key(void *handle, int64_t i, char *out, int64_t cap) {
  Pack *p = static_cast<Pack *>(handle);
  const Record &r = p->index[i];
  int64_t n = std::min<int64_t>(r.key_len, cap - 1);
  std::memcpy(out, p->data + r.key_off, n);
  out[n] = '\0';
  return r.key_len;
}

int64_t packed_image_len(void *handle, int64_t i) {
  return static_cast<Pack *>(handle)->index[i].img_len;
}

void packed_image(void *handle, int64_t i, uint8_t *out) {
  Pack *p = static_cast<Pack *>(handle);
  const Record &r = p->index[i];
  std::memcpy(out, p->data + r.img_off, r.img_len);
}

void packed_meta(void *handle, int64_t i, float *out /* 4 + 183 floats */) {
  Pack *p = static_cast<Pack *>(handle);
  const Record &r = p->index[i];
  std::memcpy(out, p->data + r.meta_off, (4 + 61 * 3) * sizeof(float));
}

// Split-half sampling with filtering; writes samples (subsample, 5) rows
// [xyz, sdf_hand_col, sdf_obj_col] and labels (subsample,).
// `hand` selects which sdf block AND the column order (reference
// utils/sdf_utils.py:171-188): for hand rows are [xyz, self, other]; for obj
// they are reordered to [xyz, other(=hand), self(=obj)].
int packed_sample_sdf(void *handle, int64_t i, int hand, int64_t subsample,
                      float clamp, int filter_dist, uint64_t seed,
                      float *out_samples, float *out_labels) {
  sample_sdf_impl(static_cast<Pack *>(handle), i, hand, subsample, clamp,
                  filter_dist, seed, out_samples, out_labels);
  return 0;
}

// ---------------------------------------------------------------------------
// Native batch builder: the full per-scene train pipeline (augmentation draw,
// rotation warp, SDF sampling, the /scale - offset -> rot -> -root -> xfactor
// -> /2 normalization chain of reference utils/data.py:110-206, and the
// [hand-half | obj-half] batch layout of to_train_batch) for a whole batch in
// one GIL-free call, parallelized over a std::thread pool.  Augmentation
// parameters reproduce the reference *distribution* (rot ~ 0.6-gated
// clip(randn,-2,2)*rot_factor, reference utils/img_utils.py:106-130) from a
// per-scene mt19937_64 stream; the warp is float bilinear (cv2-equivalent up
// to its 5-bit fixed-point interpolation).
// ---------------------------------------------------------------------------

namespace {

struct BatchConfig {
  int64_t samples_per_scene;  // N total per scene
  int hand_branch, obj_branch;
  float clamp;
  float sdf_scale_factor;
  int disable_aug;
  int occlusion_aug;
  int image_size;  // square dst
  float rot_factor;
  int dataset_obman;  // cam_extr diag(1,-1,-1) + default intrinsics
};

struct BatchOut {
  uint8_t *images;      // B*S*S*3
  float *xyz;           // B*N*3
  float *sdf_hand;      // B*N
  float *sdf_obj;       // B*N
  float *labels;        // B*N
  float *cam_intr;      // B*3*4
  float *mano_root;     // B*3
  float *rest_corners;  // B*8*3
  float *joints;        // B*21*3
  float *obj_center;    // B*3
  float *obj_corners;   // B*8*3
};

// inverse-mapped bilinear rotation warp about the raw-image center
// (gen_trans_from_patch_cv with scale=1 and a centered crop box, reference
// utils/img_utils.py:176-207): dst px -> src px = c_src + R(rot) *
// ((dst - c_dst) * (src_extent / dst_extent))
static void warp_rotate(const uint8_t *src, int sh, int sw, uint8_t *dst,
                        int dsize, float rot_deg) {
  const float cx_src = sw * 0.5f, cy_src = sh * 0.5f;
  // center-crop box of dsize x dsize: its center is the raw center minus the
  // 0.5 px convention of the bbox center ((x0 + 0.5*w), reference :106-107)
  const float bb_cx = ((sw - dsize) / 2) + 0.5f * dsize;
  const float bb_cy = ((sh - dsize) / 2) + 0.5f * dsize;
  const float c_dst = dsize * 0.5f;
  const float rad = rot_deg * 3.14159265358979323846f / 180.f;
  const float cs = std::cos(rad), sn = std::sin(rad);
  for (int y = 0; y < dsize; ++y) {
    const float dy = y - c_dst;
    for (int x = 0; x < dsize; ++x) {
      const float dx = x - c_dst;
      // rotate_2d(pt, rad) = [x cs - y sn, x sn + y cs]
      const float sx = bb_cx + dx * cs - dy * sn;
      const float sy = bb_cy + dx * sn + dy * cs;
      uint8_t *out = dst + (y * dsize + x) * 3;
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      if (x0 < 0 || y0 < 0 || x0 + 1 >= sw || y0 + 1 >= sh) {
        // border: clamp to edge pixels contributing 0 outside (cv2 constant 0)
        for (int c = 0; c < 3; ++c) out[c] = 0;
        if (x0 >= -1 && y0 >= -1 && x0 < sw && y0 < sh) {
          const float fx = sx - x0, fy = sy - y0;
          float acc[3] = {0, 0, 0};
          for (int oy = 0; oy < 2; ++oy)
            for (int ox = 0; ox < 2; ++ox) {
              const int xi = x0 + ox, yi = y0 + oy;
              if (xi < 0 || yi < 0 || xi >= sw || yi >= sh) continue;
              const float w = (ox ? fx : 1 - fx) * (oy ? fy : 1 - fy);
              const uint8_t *px = src + (yi * sw + xi) * 3;
              for (int c = 0; c < 3; ++c) acc[c] += w * px[c];
            }
          for (int c = 0; c < 3; ++c)
            out[c] = static_cast<uint8_t>(
                std::min(255.f, std::max(0.f, acc[c] + 0.5f)));
        }
        continue;
      }
      const float fx = sx - x0, fy = sy - y0;
      const uint8_t *p00 = src + (y0 * sw + x0) * 3;
      const uint8_t *p01 = p00 + 3;
      const uint8_t *p10 = p00 + sw * 3;
      const uint8_t *p11 = p10 + 3;
      for (int c = 0; c < 3; ++c) {
        const float v = (1 - fy) * ((1 - fx) * p00[c] + fx * p01[c]) +
                        fy * ((1 - fx) * p10[c] + fx * p11[c]);
        out[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

static void build_scene(const Pack *p, int64_t rec, uint64_t seed,
                        const BatchConfig &cfg, int64_t b, const BatchOut &o) {
  const Record &r = p->index[rec];
  const float *meta = reinterpret_cast<const float *>(p->data + r.meta_off);
  const float scale = meta[0];
  const float off0 = meta[1], off1 = meta[2], off2 = meta[3];
  const float *block = meta + 4;  // (61, 3)

  // cam_extr rows: obman = diag(1,-1,-1)
  const float ey = cfg.dataset_obman ? -1.f : 1.f;
  const float ez = cfg.dataset_obman ? -1.f : 1.f;

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uf(0.0, 1.0);
  std::normal_distribution<double> nd(0.0, 1.0);

  // rotation draw (reference utils/img_utils.py:120: 0.6-gated randn)
  float rot = 0.f;
  if (!cfg.disable_aug) {
    const double gate = uf(rng);
    const double z = nd(rng);
    if (gate <= 0.6)
      rot = static_cast<float>(
          std::min(2.0, std::max(-2.0, z)) * cfg.rot_factor);
  }
  const float nrad = -rot * 3.14159265358979323846f / 180.f;
  const float rc = std::cos(nrad), rs = std::sin(nrad);
  // rot_aug_mat = Rz(-rot) (reference utils/data.py:136)
  auto rot_aug = [&](float &x, float &y) {
    const float nx = rc * x - rs * y;
    const float ny = rs * x + rc * y;
    x = nx;
    y = ny;
  };

  // --- image: center crop + rotation warp (img_scale forced to 1,
  // reference utils/data.py:133)
  {
    const int sw = static_cast<int>(
        std::lround(std::sqrt(static_cast<double>(r.img_len) / 3)));
    const uint8_t *img = p->data + r.img_off;
    uint8_t *dst = o.images + b * cfg.image_size * cfg.image_size * 3;
    warp_rotate(img, sw, sw, dst, cfg.image_size, rot);
  }

  // --- joints / corners through cam_extr then the rot aug
  float joints[21][3], corners[9][3], rest[9][3];
  for (int j = 0; j < 21; ++j) {
    joints[j][0] = block[j * 3 + 0];
    joints[j][1] = ey * block[j * 3 + 1];
    joints[j][2] = ez * block[j * 3 + 2];
    rot_aug(joints[j][0], joints[j][1]);
  }
  for (int j = 0; j < 9; ++j) {
    const float *row = block + (21 + j) * 3;
    corners[j][0] = row[0];
    corners[j][1] = ey * row[1];
    corners[j][2] = ez * row[2];
    rot_aug(corners[j][0], corners[j][1]);
    const float *rrow = block + (30 + j) * 3;
    rest[j][0] = rrow[0];
    rest[j][1] = ey * rrow[1];
    rest[j][2] = ez * rrow[2];
  }
  const float root[3] = {joints[0][0], joints[0][1], joints[0][2]};

  for (int j = 0; j < 21; ++j)
    for (int c = 0; c < 3; ++c) o.joints[(b * 21 + j) * 3 + c] = joints[j][c];
  for (int c = 0; c < 3; ++c) {
    o.mano_root[b * 3 + c] = root[c];
    o.obj_center[b * 3 + c] = corners[0][c];
  }
  for (int j = 0; j < 8; ++j)
    for (int c = 0; c < 3; ++c) {
      o.obj_corners[(b * 8 + j) * 3 + c] = corners[j + 1][c] - corners[0][c];
      o.rest_corners[(b * 8 + j) * 3 + c] = rest[j + 1][c];
    }

  // --- cam_intr (3,4): obman constant else block[58:61]; cx/cy rescaled to
  // the crop (reference utils/data.py:138-141 with raw square images)
  {
    float K[3][4] = {{0}};
    if (cfg.dataset_obman) {
      K[0][0] = 480.f;
      K[0][2] = 128.f;
      K[1][1] = 480.f;
      K[1][2] = 128.f;
      K[2][2] = 1.f;
    } else {
      for (int i2 = 0; i2 < 3; ++i2)
        for (int j2 = 0; j2 < 3; ++j2) K[i2][j2] = block[(58 + i2) * 3 + j2];
    }
    const int sw = static_cast<int>(
        std::lround(std::sqrt(static_cast<double>(r.img_len) / 3)));
    K[0][2] = K[0][2] / sw * cfg.image_size;
    K[1][2] = K[1][2] / sw * cfg.image_size;
    std::memcpy(o.cam_intr + b * 12, K, 12 * sizeof(float));
  }

  // --- SDF sampling + normalization chain into the flat batch layout
  const int both = cfg.hand_branch && cfg.obj_branch;
  const int64_t per_branch =
      both ? cfg.samples_per_scene / 2 : cfg.samples_per_scene;
  const int64_t N = cfg.samples_per_scene;
  std::vector<float> samples(per_branch * 5), labels(per_branch);

  auto emit_branch = [&](int hand, int64_t out_base, uint64_t branch_seed) {
    const int enabled = hand ? cfg.hand_branch : cfg.obj_branch;
    if (enabled) {
      sample_sdf_impl(p, rec, hand, per_branch, cfg.clamp, /*filter=*/1,
                      branch_seed, samples.data(), labels.data());
    } else {
      std::fill(samples.begin(), samples.end(), 0.f);
      std::fill(labels.begin(), labels.end(), -1.f);
    }
    const float k = cfg.sdf_scale_factor;
    for (int64_t s = 0; s < per_branch; ++s) {
      float x = samples[s * 5 + 0] / scale - off0;
      float y = samples[s * 5 + 1] / scale - off1;
      float z = samples[s * 5 + 2] / scale - off2;
      rot_aug(x, y);
      const int64_t row = b * N + out_base + s;
      o.xyz[row * 3 + 0] = (x - root[0]) * k * 0.5f;
      o.xyz[row * 3 + 1] = (y - root[1]) * k * 0.5f;
      o.xyz[row * 3 + 2] = (z - root[2]) * k * 0.5f;
      o.sdf_hand[row] = samples[s * 5 + 3] / scale * k * 0.5f;
      o.sdf_obj[row] = samples[s * 5 + 4] / scale * k * 0.5f;
      o.labels[row] = labels[s];
    }
  };

  // branch seeds: fixed xor tags so tests can reproduce each branch draw
  emit_branch(/*hand=*/1, 0, seed ^ 0x68616e64ULL);
  if (both) emit_branch(/*hand=*/0, per_branch, seed ^ 0x6f626a00ULL);
}

}  // namespace

int packed_build_batch(void *handle, int64_t batch, const int64_t *indices,
                       const uint64_t *seeds, int64_t samples_per_scene,
                       int hand_branch, int obj_branch, float clamp,
                       float sdf_scale_factor, int disable_aug,
                       int occlusion_aug, int image_size, float rot_factor,
                       int dataset_obman, uint8_t *out_images, float *out_xyz,
                       float *out_sdf_hand, float *out_sdf_obj,
                       float *out_labels, float *out_cam_intr,
                       float *out_mano_root, float *out_rest_corners,
                       float *out_joints, float *out_obj_center,
                       float *out_obj_corners, int num_threads) {
  Pack *p = static_cast<Pack *>(handle);
  BatchConfig cfg{samples_per_scene, hand_branch, obj_branch, clamp,
                  sdf_scale_factor, disable_aug, occlusion_aug, image_size,
                  rot_factor, dataset_obman};
  BatchOut out{out_images,      out_xyz,    out_sdf_hand,   out_sdf_obj,
               out_labels,      out_cam_intr, out_mano_root, out_rest_corners,
               out_joints,      out_obj_center, out_obj_corners};
  if (num_threads <= 0)
    num_threads = std::max(1u, std::thread::hardware_concurrency());
  num_threads = std::min<int64_t>(num_threads, batch);

  std::vector<std::thread> pool;
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int64_t b = t; b < batch; b += num_threads)
        build_scene(p, indices[b], seeds[b], cfg, b, out);
    });
  }
  for (auto &th : pool) th.join();
  return 0;
}

int packed_reader_version() { return 2; }

}  // extern "C"
