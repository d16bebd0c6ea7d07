"""Pure-NumPy CPU oracle implementing the reference server's mapping
semantics (server_nodes/dual_bot_mapper.py), used to verify the JAX engine
bit-for-bit at the cell-state level. Deliberately written in the slow,
sequential style of the reference so it serves as an independent check on
the batched kernels — this module is TEST CODE, never a compute path.
"""

from __future__ import annotations

import math

import numpy as np

# Reference constants (dual_bot_mapper.py:56-103).
MAX_DIST_M = 1.20
MIN_DIST_M = 0.05
GRID_SIZE = 200
GRID_RES = 0.05
GRID_OX = -5.0
GRID_OY = -5.0
UNKNOWN, FREE, OCCUPIED = -1, 0, 100
SENSOR_ANGLES = [0.0, math.pi / 2, math.pi, -math.pi / 2]  # f, l, b, r
CLOSURE_RADIUS = 0.60
MIN_POSES_BETWEEN = 30
CLOSURE_CORRECTION = 0.5


def world_to_grid(wx, wy):
    # int() truncates toward zero — ref dual_bot_mapper.py:123-124.
    return int((wx - GRID_OX) / GRID_RES), int((wy - GRID_OY) / GRID_RES)


def bresenham(x0, y0, x1, y1):
    cells = []
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    while True:
        cells.append((x0, y0))
        if x0 == x1 and y0 == y1:
            return cells
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy


class OracleGrid:
    def __init__(self):
        self.grid = np.full((GRID_SIZE, GRID_SIZE), UNKNOWN, np.int8)

    def update_ray(self, rx, ry, hx, hy, hit_valid):
        x0, y0 = world_to_grid(rx, ry)
        x1, y1 = world_to_grid(hx, hy)
        cells = bresenham(x0, y0, x1, y1)
        for gx, gy in cells[:-1]:
            if 0 <= gx < GRID_SIZE and 0 <= gy < GRID_SIZE:
                self.grid[gy, gx] = FREE
        if cells and hit_valid:
            gx, gy = cells[-1]
            if 0 <= gx < GRID_SIZE and 0 <= gy < GRID_SIZE:
                self.grid[gy, gx] = OCCUPIED

    def ingest_packet(self, rx, ry, ryaw, dists4):
        """The per-packet sensor projection loop (dual_bot_mapper.py:881-904).
        Returns list of world hits for the point cloud."""
        hits = []
        for dist, rel in zip(dists4, SENSOR_ANGLES):
            a = ryaw + rel
            valid = MIN_DIST_M < dist <= MAX_DIST_M
            if valid:
                wx = rx + dist * math.cos(a)
                wy = ry + dist * math.sin(a)
                hits.append((wx, wy))
                self.update_ray(rx, ry, wx, wy, True)
            else:
                rng = min(dist, MAX_DIST_M) if dist > MIN_DIST_M else MAX_DIST_M
                self.update_ray(rx, ry, rx + rng * math.cos(a),
                                ry + rng * math.sin(a), False)
        return hits

    def frontiers(self):
        """FREE cells 4-adjacent to UNKNOWN (dual_bot_mapper.py:181-196)."""
        out = []
        g = self.grid
        for y in range(1, GRID_SIZE - 1):
            for x in range(1, GRID_SIZE - 1):
                if g[y, x] != FREE:
                    continue
                if (g[y, x - 1] == UNKNOWN or g[y, x + 1] == UNKNOWN or
                        g[y - 1, x] == UNKNOWN or g[y + 1, x] == UNKNOWN):
                    out.append((x, y))
        return out

    def cluster(self, cells):
        """BFS flood fill, min size 3 (dual_bot_mapper.py:198-231)."""
        cell_set = set(cells)
        visited, clusters = set(), []
        for c in cells:
            if c in visited:
                continue
            comp, queue = [], [c]
            while queue:
                q = queue.pop(0)
                if q in visited:
                    continue
                visited.add(q)
                comp.append(q)
                for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    nb = (q[0] + dx, q[1] + dy)
                    if nb in cell_set and nb not in visited:
                        queue.append(nb)
            if len(comp) >= 3:
                clusters.append(comp)
        return clusters


class OracleSlam:
    """Sequential landmark loop closure (dual_bot_mapper.py:261-338)."""

    def __init__(self):
        self.n_nodes = 0
        self.landmarks = []   # (x, y, type, node_index)
        self.closures = []    # (lm_idx, node_idx, cdx, cdy)
        self.last_closure_idx = {}

    def add_pose(self, x, y, yaw, agent_id, lm_type):
        idx = self.n_nodes
        self.n_nodes += 1
        if lm_type == 0:
            return False, 0.0, 0.0
        hit = (False, 0.0, 0.0)
        for lm_x, lm_y, t, lm_idx in self.landmarks:
            if t != lm_type:
                continue
            if idx - lm_idx < MIN_POSES_BETWEEN:
                continue
            if idx - self.last_closure_idx.get(agent_id, -999) < MIN_POSES_BETWEEN:
                continue
            d = math.sqrt((x - lm_x) ** 2 + (y - lm_y) ** 2)
            if d < CLOSURE_RADIUS:
                cdx = (lm_x - x) * CLOSURE_CORRECTION
                cdy = (lm_y - y) * CLOSURE_CORRECTION
                self.closures.append((lm_idx, idx, cdx, cdy))
                self.last_closure_idx[agent_id] = idx
                hit = (True, cdx, cdy)
                break
        self.landmarks.append((x, y, lm_type, idx))
        return hit


def oracle_ekf_predict(x, P, omega_meas, dt, q_diag):
    """NumPy port of ekf.cpp:26-68 for bitwise-ish comparison."""
    x = x.copy()
    theta, v, bias = x[2], x[3], x[5]
    omega_c = omega_meas - bias
    theta_new = theta + omega_c * dt
    if theta_new > math.pi:
        theta_new -= 2 * math.pi
    elif theta_new < -math.pi:
        theta_new += 2 * math.pi
    x[0] += v * math.cos(theta) * dt
    x[1] += v * math.sin(theta) * dt
    x[2] = theta_new
    x[4] = omega_c
    J = np.eye(6)
    J[0, 2] = -v * math.sin(theta) * dt
    J[0, 3] = math.cos(theta) * dt
    J[1, 2] = v * math.cos(theta) * dt
    J[1, 3] = math.sin(theta) * dt
    J[2, 5] = -dt
    J[4, 4] = 0.0
    J[4, 5] = -1.0
    P = J @ P @ J.T + np.diag(q_diag)
    return x, P


def oracle_ekf_update(x, P, v_meas, w_meas, r_diag):
    """NumPy port of ekf.cpp:70-92."""
    H = np.zeros((2, 6))
    H[0, 3] = 1.0
    H[1, 4] = 1.0
    z = np.array([v_meas, w_meas])
    y = z - np.array([x[3], x[4]])
    S = H @ P @ H.T + np.diag(r_diag)
    K = P @ H.T @ np.linalg.inv(S)
    x = x + K @ y
    P = (np.eye(6) - K @ H) @ P
    return x, P


class OracleServer:
    """Full sequential ingest: offsets + drift correction + grid + closure
    (dual_bot_mapper.py main loop RX block, :814-919)."""

    def __init__(self, n_agents=2, offsets=None):
        self.grid = OracleGrid()
        self.slam = OracleSlam()
        self.drift = {a: (0.0, 0.0) for a in range(n_agents)}
        self.offsets = offsets or [0.0] * n_agents
        self.log = []          # corrected (rx, ry) per packet
        self.closure_events = []

    def ingest(self, t, agent, x, y, yaw, dists4, lm_type):
        rx = x + self.offsets[agent] + self.drift[agent][0]
        ry = y + self.drift[agent][1]
        self.grid.ingest_packet(rx, ry, yaw, dists4)
        closed, cdx, cdy = self.slam.add_pose(rx, ry, yaw, agent, lm_type)
        if closed:
            self.drift[agent] = (self.drift[agent][0] + cdx,
                                 self.drift[agent][1] + cdy)
            self.closure_events.append((len(self.log), cdx, cdy))
        self.log.append((rx, ry))
        return closed
