// Native C++ oracle for the JAX swarm engine.
//
// Independent scalar implementations of the algorithmic cores, used by the
// test suite for bit-level comparison against the batched JAX
// kernels (SURVEY.md "Native-component note"):
//
//   * 6-state EKF predict/update   — semantics of AgentFirmware_Bot1/
//     ekf.cpp:26-92 (unicycle motion model, analytic Jacobian, encoder
//     (v, omega) update with closed-form 2x2 innovation inverse)
//   * Bresenham ray traversal      — server_nodes/dual_bot_mapper.py:158-179
//   * occupancy update_ray         — dual_bot_mapper.py:136-156 (path FREE,
//     endpoint OCCUPIED when hit trusted; int-truncation world_to_grid)
//   * landmark-closure check       — dual_bot_mapper.py:292-326 (first
//     insertion-order match, index-gap + radius + per-agent guards)
//
// Everything is extern "C", plain buffers, no globals — callable from
// ctypes with numpy arrays. Float32 state mirrors the firmware's Eigen
// floats so EKF comparisons are apples-to-apples.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// EKF: state [x, y, theta, v, omega, bias], covariance row-major [6*6].
// ---------------------------------------------------------------------------

static void mat6_mul(const float* a, const float* b, float* out) {
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      float s = 0.f;
      for (int k = 0; k < 6; ++k) s += a[i * 6 + k] * b[k * 6 + j];
      out[i * 6 + j] = s;
    }
}

static void mat6_mul_bt(const float* a, const float* b, float* out) {
  // out = a * b^T
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      float s = 0.f;
      for (int k = 0; k < 6; ++k) s += a[i * 6 + k] * b[j * 6 + k];
      out[i * 6 + j] = s;
    }
}

static float wrap_pi(float a) {
  while (a > static_cast<float>(M_PI)) a -= 2.f * static_cast<float>(M_PI);
  while (a < -static_cast<float>(M_PI)) a += 2.f * static_cast<float>(M_PI);
  return a;
}

void ekf_oracle_init(float* x, float* P) {
  std::memset(x, 0, 6 * sizeof(float));
  std::memset(P, 0, 36 * sizeof(float));
  for (int i = 0; i < 6; ++i) P[i * 6 + i] = 1.f;
}

// q_diag: [6], dt guard: no-op when dt <= 0 (ekf.cpp:30).
void ekf_oracle_predict(float* x, float* P, float omega_measured, float dt,
                        const float* q_diag) {
  if (dt <= 0.f) return;
  const float theta = x[2];
  const float v = x[3];
  const float bias = x[5];
  const float omega_c = omega_measured - bias;

  x[0] += v * std::cos(theta) * dt;
  x[1] += v * std::sin(theta) * dt;
  x[2] = wrap_pi(theta + omega_c * dt);
  x[4] = omega_c;

  float jac[36];
  std::memset(jac, 0, sizeof(jac));
  for (int i = 0; i < 6; ++i) jac[i * 6 + i] = 1.f;
  jac[0 * 6 + 2] = -v * std::sin(theta) * dt;
  jac[0 * 6 + 3] = std::cos(theta) * dt;
  jac[1 * 6 + 2] = v * std::cos(theta) * dt;
  jac[1 * 6 + 3] = std::sin(theta) * dt;
  jac[2 * 6 + 5] = -dt;
  jac[4 * 6 + 4] = 0.f;
  jac[4 * 6 + 5] = -1.f;

  float tmp[36], newP[36];
  mat6_mul(jac, P, tmp);
  mat6_mul_bt(tmp, jac, newP);
  for (int i = 0; i < 6; ++i) newP[i * 6 + i] += q_diag[i];
  std::memcpy(P, newP, sizeof(newP));
}

// r_diag: [2] (v, omega) measurement noise.
void ekf_oracle_update(float* x, float* P, float v_meas, float omega_meas,
                       const float* r_diag) {
  const int iv = 3, iw = 4;
  const float s00 = P[iv * 6 + iv] + r_diag[0];
  const float s01 = P[iv * 6 + iw];
  const float s10 = P[iw * 6 + iv];
  const float s11 = P[iw * 6 + iw] + r_diag[1];
  const float det = s00 * s11 - s01 * s10;
  const float i00 = s11 / det, i01 = -s01 / det;
  const float i10 = -s10 / det, i11 = s00 / det;

  float K[12];  // [6 x 2]
  for (int i = 0; i < 6; ++i) {
    const float p0 = P[i * 6 + iv];
    const float p1 = P[i * 6 + iw];
    K[i * 2 + 0] = p0 * i00 + p1 * i10;
    K[i * 2 + 1] = p0 * i01 + p1 * i11;
  }

  const float r0 = v_meas - x[iv];
  const float r1 = omega_meas - x[iw];
  for (int i = 0; i < 6; ++i) x[i] += K[i * 2 + 0] * r0 + K[i * 2 + 1] * r1;

  // P = (I - K H) P; K H has non-zero columns (iv, iw) only.
  float KH[36];
  std::memset(KH, 0, sizeof(KH));
  for (int i = 0; i < 6; ++i) {
    KH[i * 6 + iv] = K[i * 2 + 0];
    KH[i * 6 + iw] = K[i * 2 + 1];
  }
  float IKH[36];
  for (int i = 0; i < 36; ++i) IKH[i] = -KH[i];
  for (int i = 0; i < 6; ++i) IKH[i * 6 + i] += 1.f;
  float newP[36];
  mat6_mul(IKH, P, newP);
  std::memcpy(P, newP, sizeof(newP));
}

// ---------------------------------------------------------------------------
// Bresenham + occupancy grid (reference server semantics).
// ---------------------------------------------------------------------------

// Writes up to max_n (x, y) pairs into out_xy; returns count.
int bresenham_oracle(int x0, int y0, int x1, int y1, int32_t* out_xy,
                     int max_n) {
  int dx = std::abs(x1 - x0), dy = std::abs(y1 - y0);
  int sx = x0 < x1 ? 1 : -1;
  int sy = y0 < y1 ? 1 : -1;
  int err = dx - dy;
  int n = 0;
  int x = x0, y = y0;
  while (n < max_n) {
    out_xy[n * 2] = x;
    out_xy[n * 2 + 1] = y;
    ++n;
    if (x == x1 && y == y1) break;
    int e2 = 2 * err;
    if (e2 > -dy) { err -= dy; x += sx; }
    if (e2 < dx)  { err += dx; y += sy; }
  }
  return n;
}

// grid: int8 [size*size] row-major (gy, gx); states -1/0/100.
// Returns number of cell writes. Mirrors OccupancyGrid.update_ray
// (dual_bot_mapper.py:136-156): int() truncation toward zero for
// world_to_grid (:123-124), path cells FREE, endpoint OCCUPIED iff hit.
int update_ray_oracle(int8_t* grid, int size, float res, float ox, float oy,
                      float rx, float ry, float wx, float wy, int hit) {
  const int x0 = static_cast<int>((rx - ox) / res);
  const int y0 = static_cast<int>((ry - oy) / res);
  const int x1 = static_cast<int>((wx - ox) / res);
  const int y1 = static_cast<int>((wy - oy) / res);
  int32_t cells[4096];
  const int n = bresenham_oracle(x0, y0, x1, y1, cells, 2048);
  int writes = 0;
  for (int i = 0; i < n; ++i) {
    const int cx = cells[i * 2], cy = cells[i * 2 + 1];
    if (cx < 0 || cx >= size || cy < 0 || cy >= size) continue;
    if (i == n - 1) {
      if (hit) { grid[cy * size + cx] = 100; ++writes; }
    } else {
      grid[cy * size + cx] = 0;
      ++writes;
    }
  }
  return writes;
}

// ---------------------------------------------------------------------------
// Landmark loop-closure check (dual_bot_mapper.py:292-326).
// ---------------------------------------------------------------------------

// Landmark store arrays of length n_lm (insertion order). Returns matched
// slot or -1; fills correction (damped).
int closure_check_oracle(const float* lm_x, const float* lm_y,
                         const int32_t* lm_type, const int32_t* lm_node,
                         int n_lm, float x, float y, int lm, int node_idx,
                         int last_closure_node, int min_gap, float radius,
                         float damping, float* out_dx, float* out_dy) {
  *out_dx = 0.f;
  *out_dy = 0.f;
  if (lm == 0) return -1;
  if (node_idx - last_closure_node < min_gap) return -1;
  const float r2 = radius * radius;
  for (int i = 0; i < n_lm; ++i) {
    if (lm_type[i] != lm) continue;
    if (node_idx - lm_node[i] < min_gap) continue;
    const float dx = x - lm_x[i];
    const float dy = y - lm_y[i];
    if (dx * dx + dy * dy < r2) {
      *out_dx = (lm_x[i] - x) * damping;
      *out_dy = (lm_y[i] - y) * damping;
      return i;
    }
  }
  return -1;
}

}  // extern "C"
