// Native host-side runtime components — the port's own copy of
// tpu_slam/native/tpu_slam_native.cpp, the same code, so that its outputs
// equal the reference's bit for bit when built with the same flags
// (tpu_slam_torch/native/__init__.py).
//
// The host-side pieces that benefit from native code live here:
//
//   * ts_raycast       — batched exact ray/segment intersection: the data
//                        generator for tests and benches (the simulator's
//                        inner loop; numpy version in data/simulator.py).
//   * ts_bresenham     — per-beam integer Bresenham with the reference's
//                        once-per-scan cell semantics (gridlinetraversal.h:
//                        27-207 and OccGridMapBase.h:270-330): the golden
//                        CPU reference for the device rasterizer.
//   * ts_karto_counts  — Karto's CreateFromScans pass/hit counters on the
//                        host (occupancy_from_scans(engine="native")).
//   * ts_decimate      — beam-wise range decimation/min-filter used by the
//                        host data pipeline when downsampling scans.
//   * ts_bag_*         — native rosbag-2.0 decoder/data-loader: replaces the
//                        reference's rosbag replay transport (L0, SURVEY §1;
//                        lessonN/launch/*.launch play lesson bags). Walks
//                        chunk records (bz2 via dlopen'd libbz2), and bulk-
//                        decodes LaserScan/Imu/Odometry streams directly
//                        into caller-provided (numpy) buffers — the host IO
//                        path feeding device tensors.
//
// Built as a plain C ABI shared library with g++; Python binds via ctypes
// (tpu_slam_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <functional>
#include <limits>
#include <string>
#include <vector>
#include <unordered_map>
#include <cstdio>
#include <dlfcn.h>

extern "C" {

// Batched ray ↔ segment-set intersection.
// segments: (n_seg, 4) [x1,y1,x2,y2]; origins: (n_rays, 2); angles: (n_rays).
// out: (n_rays) ranges, +inf when nothing hit within range_max.
void ts_raycast(const double* segments, int64_t n_seg,
                const double* origins, const double* angles, int64_t n_rays,
                double range_max, double* out) {
  for (int64_t r = 0; r < n_rays; ++r) {
    const double ox = origins[2 * r], oy = origins[2 * r + 1];
    const double dx = std::cos(angles[r]), dy = std::sin(angles[r]);
    double best = std::numeric_limits<double>::infinity();
    for (int64_t s = 0; s < n_seg; ++s) {
      const double px = segments[4 * s], py = segments[4 * s + 1];
      const double qx = segments[4 * s + 2], qy = segments[4 * s + 3];
      const double ex = qx - px, ey = qy - py;
      const double denom = dx * ey - dy * ex;
      if (std::fabs(denom) < 1e-12) continue;
      const double wx = px - ox, wy = py - oy;
      const double t = (wx * ey - wy * ex) / denom;
      const double u = (wx * dy - wy * dx) / denom;
      if (t > 1e-9 && u >= 0.0 && u <= 1.0 && t < best) best = t;
    }
    out[r] = (best <= range_max) ? best
                                 : std::numeric_limits<double>::infinity();
  }
}

// Reference-exact scan rasterization: integer Bresenham free cells per beam
// plus endpoint occupancy, with once-per-scan dedup and occupied-beats-free
// (hector updateLineBresenhami/bresenham2D + update-index stamps,
// OccGridMapBase.h:220-330). Outputs two uint8 masks of size (h*w).
void ts_bresenham_masks(const double* origin_cell,       // (2,) fractional
                        const double* end_cells,         // (n, 2) fractional
                        const uint8_t* valid, int64_t n,
                        int64_t w, int64_t h,
                        uint8_t* free_mask, uint8_t* occ_mask) {
  std::memset(free_mask, 0, (size_t)(w * h));
  std::memset(occ_mask, 0, (size_t)(w * h));
  const int64_t x0 = (int64_t)std::floor(origin_cell[0]);
  const int64_t y0 = (int64_t)std::floor(origin_cell[1]);
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    const int64_t x1 = (int64_t)std::floor(end_cells[2 * i]);
    const int64_t y1 = (int64_t)std::floor(end_cells[2 * i + 1]);
    // bresenham2D free cells, stopping before the end cell
    int64_t dx = std::llabs(x1 - x0), dy = std::llabs(y1 - y0);
    const int64_t sx = x0 < x1 ? 1 : -1, sy = y0 < y1 ? 1 : -1;
    int64_t x = x0, y = y0;
    int64_t err = dx - dy;
    while (!(x == x1 && y == y1)) {
      if (x >= 0 && x < w && y >= 0 && y < h) free_mask[y * w + x] = 1;
      const int64_t e2 = 2 * err;
      if (e2 > -dy) { err -= dy; x += sx; }
      if (e2 < dx)  { err += dx; y += sy; }
    }
    if (x1 >= 0 && x1 < w && y1 >= 0 && y1 < h) occ_mask[y1 * w + x1] = 1;
  }
  // occupied beats free (unset-free correction, OccGridMapBase.h:315-330)
  for (int64_t c = 0; c < w * h; ++c)
    if (occ_mask[c]) free_mask[c] = 0;
}

// math::Round (half away from zero), the karto WorldToGrid convention
static inline int64_t karto_round(float v) {
  return (int64_t)(v >= 0.0f ? std::floor(v + 0.5f) : std::ceil(v - 0.5f));
}

// Karto CreateFromScans pass/hit counters over a WHOLE mission — EXACT
// reference semantics (AddScan -> RayTrace -> counters, Karto.h:5886-5950),
// mirroring the device rasterizer (ops/gridmap.karto_counts_update_scan):
// skip r<=min / r>=max / NaN; clamp the ray at the range threshold (scale
// the world vector by threshold/r); TraceLine Bresenham marks every visited
// in-bounds cell +1 pass INCLUSIVE of the endpoint cell; a valid endpoint
// (r < threshold - 1e-6) adds one more pass and a hit. The host-native path
// for offline/publish map regeneration — scatter-adds are the one primitive
// where XLA-on-TPU loses to a scalar loop (superlinear scatter cost, see
// BENCHMARKS.md). Validated cell-identical against the compiled reference
// (tests/test_golden_karto.py).
void ts_karto_counts(const float* origins,    // (T, 2) world
                     const float* endpoints,  // (T, N, 2) world (raw)
                     const float* ranges,     // (T, N) raw readings
                     int64_t T, int64_t N,
                     float res, float gox, float goy,
                     int64_t W, int64_t H,
                     float range_threshold, float min_range, float max_range,
                     int32_t* pass_cnt, int32_t* hit_cnt) {  // (H*W)
  const float inv_res = 1.0f / res;
  for (int64_t t = 0; t < T; ++t) {
    const float ox = origins[2 * t], oy = origins[2 * t + 1];
    const int64_t x0 = karto_round((ox - gox) * inv_res);
    const int64_t y0 = karto_round((oy - goy) * inv_res);
    for (int64_t b = 0; b < N; ++b) {
      const float r = ranges[t * N + b];
      if (!(r > min_range) || !(r < max_range) || std::isnan(r)) continue;
      float ex = endpoints[(t * N + b) * 2];
      float ey = endpoints[(t * N + b) * 2 + 1];
      const bool end_valid = r < (range_threshold - 1e-6f);
      if (r >= range_threshold) {  // trace up to the threshold
        const float ratio = range_threshold / r;
        ex = ox + ratio * (ex - ox);
        ey = oy + ratio * (ey - oy);
      }
      const int64_t x1 = karto_round((ex - gox) * inv_res);
      const int64_t y1 = karto_round((ey - goy) * inv_res);
      // TraceLine (Karto.h:4680-4745): steep/x-swap normalized Bresenham,
      // endpoint INCLUSIVE
      int64_t ax0 = x0, ay0 = y0, ax1 = x1, ay1 = y1;
      const bool steep = std::llabs(ay1 - ay0) > std::llabs(ax1 - ax0);
      if (steep) { std::swap(ax0, ay0); std::swap(ax1, ay1); }
      if (ax0 > ax1) { std::swap(ax0, ax1); std::swap(ay0, ay1); }
      const int64_t dX = ax1 - ax0;
      const int64_t dY = std::llabs(ay1 - ay0);
      const int64_t ystep = ay0 < ay1 ? 1 : -1;
      int64_t err = 0, y = ay0;
      for (int64_t x = ax0; x <= ax1; ++x) {
        const int64_t px = steep ? y : x;
        const int64_t py = steep ? x : y;
        if (px >= 0 && px < W && py >= 0 && py < H) pass_cnt[py * W + px]++;
        err += dY;
        if (2 * err >= dX) { y += ystep; err -= dX; }
      }
      if (end_valid && x1 >= 0 && x1 < W && y1 >= 0 && y1 < H) {
        pass_cnt[y1 * W + x1]++;
        hit_cnt[y1 * W + x1]++;
      }
    }
  }
}

// Min-filter decimation of a range scan: out[j] = min over the window
// (keeps obstacles when downsampling beams for coarse pyramid levels).
void ts_decimate(const float* ranges, int64_t n, int64_t factor, float* out) {
  const int64_t m = n / factor;
  for (int64_t j = 0; j < m; ++j) {
    float best = std::numeric_limits<float>::infinity();
    for (int64_t k = 0; k < factor; ++k) {
      const float v = ranges[j * factor + k];
      if (v < best) best = v;
    }
    out[j] = best;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// rosbag 2.0 decoder (format: http://wiki.ros.org/Bags/Format/2.0)
// ---------------------------------------------------------------------------

namespace {

using bz2_fn = int (*)(char*, unsigned*, char*, unsigned, int, int);

bz2_fn load_bz2() {
  static bz2_fn fn = [] {
    for (const char* name : {"libbz2.so.1", "libbz2.so.1.0", "libbz2.so"}) {
      if (void* h = dlopen(name, RTLD_LAZY | RTLD_GLOBAL)) {
        if (void* s = dlsym(h, "BZ2_bzBuffToBuffDecompress"))
          return reinterpret_cast<bz2_fn>(s);
      }
    }
    return bz2_fn(nullptr);
  }();
  return fn;
}

struct Field {
  const uint8_t* val;
  uint32_t len;
};

// header block = sequence of (u32 len, "key=value") fields
bool parse_header(const uint8_t* d, uint32_t n,
                  std::unordered_map<std::string, Field>* out) {
  uint32_t o = 0;
  while (o + 4 <= n) {
    uint32_t flen;
    std::memcpy(&flen, d + o, 4);
    o += 4;
    if (o + flen > n) return false;
    const uint8_t* eq =
        static_cast<const uint8_t*>(std::memchr(d + o, '=', flen));
    if (eq) {
      std::string key(reinterpret_cast<const char*>(d + o), eq - (d + o));
      (*out)[key] = Field{eq + 1, (uint32_t)(flen - (eq + 1 - (d + o)))};
    }
    o += flen;
  }
  return o == n;
}

struct MsgView {
  const std::string* topic;
  const std::string* type;
  double rx_time;  // receive time (sec)
  const uint8_t* body;
  uint32_t len;
};

// Walk every record (descending into chunks); invoke cb per message-data
// record. Returns 0 ok, <0 error.
int walk_bag(const char* path, const std::function<void(const MsgView&)>& cb) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)sz);
  if (std::fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  const char magic[] = "#ROSBAG V2.0\n";
  const size_t mlen = sizeof(magic) - 1;
  if (buf.size() < mlen || std::memcmp(buf.data(), magic, mlen) != 0)
    return -3;

  struct Conn {
    std::string topic, type;
  };
  std::unordered_map<uint32_t, Conn> conns;
  std::vector<uint8_t> scratch;  // decompressed chunk reuse

  std::function<int(const uint8_t*, size_t)> walk =
      [&](const uint8_t* d, size_t n) -> int {
    size_t o = 0;
    while (o + 8 <= n) {
      uint32_t hlen;
      std::memcpy(&hlen, d + o, 4);
      o += 4;
      if (o + hlen + 4 > n) return -4;
      std::unordered_map<std::string, Field> h;
      if (!parse_header(d + o, hlen, &h)) return -4;
      o += hlen;
      uint32_t dlen;
      std::memcpy(&dlen, d + o, 4);
      o += 4;
      if (o + dlen > n) return -4;
      const uint8_t* body = d + o;
      o += dlen;
      auto it = h.find("op");
      if (it == h.end() || it->second.len < 1) continue;
      const uint8_t op = it->second.val[0];
      if (op == 0x07) {  // connection: body holds type=...
        auto c = h.find("conn");
        auto t = h.find("topic");
        if (c == h.end() || c->second.len != 4) continue;
        uint32_t cid;
        std::memcpy(&cid, c->second.val, 4);
        std::unordered_map<std::string, Field> cf;
        parse_header(body, dlen, &cf);
        Conn conn;
        if (t != h.end())
          conn.topic.assign(reinterpret_cast<const char*>(t->second.val),
                            t->second.len);
        auto ty = cf.find("type");
        if (ty != cf.end())
          conn.type.assign(reinterpret_cast<const char*>(ty->second.val),
                           ty->second.len);
        conns[cid] = std::move(conn);
      } else if (op == 0x05) {  // chunk
        auto comp = h.find("compression");
        bool bz2 = comp != h.end() && comp->second.len == 3 &&
                   std::memcmp(comp->second.val, "bz2", 3) == 0;
        if (!bz2) {
          if (int rc = walk(body, dlen)) return rc;
        } else {
          auto szf = h.find("size");
          if (szf == h.end() || szf->second.len != 4) return -5;
          uint32_t usz;
          std::memcpy(&usz, szf->second.val, 4);
          bz2_fn dec = load_bz2();
          if (!dec) return -6;  // bz2 chunk but no libbz2 → python fallback
          scratch.resize(usz);
          unsigned dst = usz;
          if (dec(reinterpret_cast<char*>(scratch.data()), &dst,
                  const_cast<char*>(reinterpret_cast<const char*>(body)),
                  dlen, 0, 0) != 0)
            return -7;
          if (int rc = walk(scratch.data(), dst)) return rc;
        }
      } else if (op == 0x02) {  // message data
        auto c = h.find("conn");
        auto t = h.find("time");
        if (c == h.end() || c->second.len != 4) continue;
        uint32_t cid;
        std::memcpy(&cid, c->second.val, 4);
        auto ci = conns.find(cid);
        if (ci == conns.end()) continue;
        double rx = 0.0;
        if (t != h.end() && t->second.len == 8) {
          uint32_t sec, nsec;
          std::memcpy(&sec, t->second.val, 4);
          std::memcpy(&nsec, t->second.val + 4, 4);
          rx = sec + nsec * 1e-9;
        }
        cb(MsgView{&ci->second.topic, &ci->second.type, rx, body, dlen});
      }
    }
    return 0;
  };
  return walk(buf.data() + mlen, buf.size() - mlen);
}

// sequential reader over a serialized message body
struct Rd {
  const uint8_t* d;
  uint32_t n, o = 0;
  bool ok = true;
  template <typename T>
  T get() {
    T v{};
    if (o + sizeof(T) > n) { ok = false; return v; }
    std::memcpy(&v, d + o, sizeof(T));
    o += sizeof(T);
    return v;
  }
  double time() {
    uint32_t s = get<uint32_t>(), ns = get<uint32_t>();
    return s + ns * 1e-9;
  }
  void skip(uint32_t k) { if (o + k > n) ok = false; else o += k; }
  double header() {  // seq, stamp, frame_id → stamp
    skip(4);
    double t = time();
    skip(get<uint32_t>());
    return t;
  }
};

double quat_yaw(const double q[4]) {  // x y z w
  return std::atan2(2.0 * (q[3] * q[2] + q[0] * q[1]),
                    1.0 - 2.0 * (q[1] * q[1] + q[2] * q[2]));
}

}  // namespace

extern "C" {

// Count messages of `topic` in the bag. For LaserScan topics also report the
// beam count of the first message. Returns #messages, or <0 on error.
int64_t ts_bag_count(const char* path, const char* topic, int64_t* n_beams) {
  int64_t count = 0;
  int64_t beams = 0;
  int rc = walk_bag(path, [&](const MsgView& m) {
    if (*m.topic != topic) return;
    ++count;
    if (beams == 0 && *m.type == "sensor_msgs/LaserScan") {
      Rd r{m.body, m.len};
      r.header();
      r.skip(7 * 4);  // angle/time/range meta (7 f32)
      uint32_t nr = r.get<uint32_t>();
      if (r.ok) beams = nr;
    }
  });
  if (rc != 0) return rc;
  if (n_beams) *n_beams = beams;
  return count;
}

// Bulk-decode a LaserScan stream: ranges (max_msgs × n_beams f32, padded with
// +inf), stamps (f64 header stamps), meta (7 f64: angle_min, angle_max,
// angle_increment, time_increment, scan_time, range_min, range_max, from the
// first message). Returns #messages decoded, or <0 on error.
int64_t ts_bag_read_scans(const char* path, const char* topic,
                          int64_t max_msgs, int64_t n_beams, float* ranges,
                          double* stamps, double* meta) {
  int64_t k = 0;
  bool have_meta = false;
  int rc = walk_bag(path, [&](const MsgView& m) {
    if (k >= max_msgs || *m.topic != topic ||
        *m.type != "sensor_msgs/LaserScan")
      return;
    Rd r{m.body, m.len};
    double stamp = r.header();
    float mt[7];
    for (int i = 0; i < 7; ++i) mt[i] = r.get<float>();
    uint32_t nr = r.get<uint32_t>();
    if (!r.ok || r.o + 4ull * nr > m.len) return;
    if (!have_meta) {
      for (int i = 0; i < 7; ++i) meta[i] = mt[i];
      have_meta = true;
    }
    float* row = ranges + k * n_beams;
    const uint32_t ncopy = (uint32_t)std::min<int64_t>(nr, n_beams);
    std::memcpy(row, m.body + r.o, 4ull * ncopy);
    for (int64_t i = ncopy; i < n_beams; ++i)
      row[i] = std::numeric_limits<float>::infinity();
    stamps[k] = stamp;
    ++k;
  });
  return rc == 0 ? k : rc;
}

// Bulk-decode an Imu stream: stamps (f64), yaw (f64, from orientation), and
// angular velocity (max_msgs × 3 f64). Returns #messages, or <0 on error.
int64_t ts_bag_read_imu(const char* path, const char* topic, int64_t max_msgs,
                        double* stamps, double* yaw, double* gyro) {
  int64_t k = 0;
  int rc = walk_bag(path, [&](const MsgView& m) {
    if (k >= max_msgs || *m.topic != topic || *m.type != "sensor_msgs/Imu")
      return;
    Rd r{m.body, m.len};
    double stamp = r.header();
    double q[4];
    for (auto& v : q) v = r.get<double>();
    r.skip(9 * 8);  // orientation covariance
    double w[3];
    for (auto& v : w) v = r.get<double>();
    if (!r.ok) return;
    stamps[k] = stamp;
    yaw[k] = quat_yaw(q);
    for (int i = 0; i < 3; ++i) gyro[3 * k + i] = w[i];
    ++k;
  });
  return rc == 0 ? k : rc;
}

// Bulk-decode an Odometry stream: stamps (f64), pose (max_msgs × 3 f64:
// x, y, yaw), twist (max_msgs × 3 f64: vx, vy, wz). Returns #messages.
int64_t ts_bag_read_odom(const char* path, const char* topic,
                         int64_t max_msgs, double* stamps, double* pose,
                         double* twist) {
  int64_t k = 0;
  int rc = walk_bag(path, [&](const MsgView& m) {
    if (k >= max_msgs || *m.topic != topic || *m.type != "nav_msgs/Odometry")
      return;
    Rd r{m.body, m.len};
    double stamp = r.header();
    r.skip(r.get<uint32_t>());  // child_frame_id
    double p[3], q[4];
    for (auto& v : p) v = r.get<double>();
    for (auto& v : q) v = r.get<double>();
    r.skip(36 * 8);  // pose covariance
    double lin[3], ang[3];
    for (auto& v : lin) v = r.get<double>();
    for (auto& v : ang) v = r.get<double>();
    if (!r.ok) return;
    stamps[k] = stamp;
    pose[3 * k] = p[0];
    pose[3 * k + 1] = p[1];
    pose[3 * k + 2] = quat_yaw(q);
    twist[3 * k] = lin[0];
    twist[3 * k + 1] = lin[1];
    twist[3 * k + 2] = ang[2];
    ++k;
  });
  return rc == 0 ? k : rc;
}

}  // extern "C"
