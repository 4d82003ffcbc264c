"""Synthetic RGB-D scenes without cv2 (tod_tpu/utils/synthetic.py).

Procedurally textured planes, boxes and cylinders rendered into RGB-D
turntable observations (for training) and multi-object scenes (for
detection) with exact ground-truth poses: the reference's renderer line
for line, its numpy geometry and random draws unchanged, and each cv2 call
replaced by its twin in ``utils/raster.py``, so that every view, depth and
mask equals the reference's bit for bit (tests/test_torch_synthetic.py).
It runs on the host: the frames reach the card through the detector's and
the trainer's own entry points.

Conventions match the trainer/db contract: an observation's (R, T) is the
world->camera transform in column form, x_cam = R @ X_world + T — the inverse
map the trainer applies is world = (x_cam - T) @ R (training.cpp:175-195).
Detected poses are model->camera, directly comparable to the scene's
ground-truth object poses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tod_tpu_torch.utils import raster

DEFAULT_K = np.array([[525.0, 0.0, 319.5],
                      [0.0, 525.0, 239.5],
                      [0.0, 0.0, 1.0]], np.float64)


def make_texture(seed: int, size: int = 384) -> np.ndarray:
    """A corner-rich, non-repetitive deterministic texture: multi-octave
    smooth noise plus many distinct high-contrast shapes (distinctive local
    patches matter — repetitive textures make Hamming matches ambiguous,
    which is a property of the scene, not of the matcher)."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((size, size), np.float32)
    for cells, weight in ((6, 1.0), (12, 0.8), (24, 0.6), (48, 0.4)):
        layer = rng.normal(size=(cells, cells)).astype(np.float32)
        acc += weight * raster.resize_linear(layer, (size, size))
    acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
    tex = (40 + 175 * acc).astype(np.uint8)
    for _ in range(48):
        shade = int(rng.integers(0, 256))
        x, y = rng.integers(10, size - 10, 2)
        kind = rng.integers(0, 4)
        if kind == 0:
            w, h = rng.integers(6, 40, 2)
            raster.rectangle(tex, (int(x), int(y)),
                             (int(min(x + w, size - 1)),
                              int(min(y + h, size - 1))), shade, -1)
        elif kind == 1:
            raster.circle(tex, (int(x), int(y)), int(rng.integers(4, 20)),
                          shade, -1)
        elif kind == 2:
            x2, y2 = rng.integers(10, size - 10, 2)
            raster.line(tex, (int(x), int(y)), (int(x2), int(y2)), shade,
                        int(rng.integers(2, 5)))
        else:
            pts = np.stack([rng.integers(max(x - 30, 0), min(x + 30, size), 3),
                            rng.integers(max(y - 30, 0), min(y + 30, size), 3)],
                           -1).astype(np.int32)
            raster.fill_poly(tex, pts, shade)
    return tex


def look_at(camera_center: np.ndarray, target: np.ndarray,
            up: np.ndarray = np.array([0.0, 0.0, 1.0])) -> Tuple[np.ndarray, np.ndarray]:
    """World->camera (R, T): x_cam = R @ X + T; camera x right, y down,
    z forward."""
    c = np.asarray(camera_center, np.float64)
    fwd = np.asarray(target, np.float64) - c
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    T = -R @ c
    return R, T


_RAYS_CACHE: dict = {}


def _pixel_rays(K: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H,W,3) unnormalized camera-frame rays through every pixel center.

    Memoized on (K, hw): turntable/scene rendering calls this once per
    rendered face with the SAME intrinsics, and the meshgrid+matmul was
    ~85% of render time (measured on the 1-CPU bench VM). The cached array
    is marked read-only; results are bitwise identical to the uncached
    computation."""
    key = (K.tobytes(), hw)
    rays = _RAYS_CACHE.get(key)
    if rays is None:
        h, w = hw
        Kinv = np.linalg.inv(K)
        us, vs = np.meshgrid(np.arange(w), np.arange(h))
        rays = np.stack([us, vs, np.ones_like(us)], -1).astype(np.float64)
        rays = rays @ Kinv.T
        rays.flags.writeable = False
        if len(_RAYS_CACHE) > 8:   # distinct (K, hw) pairs are few by design
            _RAYS_CACHE.clear()
        _RAYS_CACHE[key] = rays
    return rays


def render_quad(texture: np.ndarray, corners_obj: np.ndarray, R: np.ndarray,
                T: np.ndarray, K: np.ndarray, hw: Tuple[int, int],
                canvas: np.ndarray, depth_buf: np.ndarray,
                cull: bool = True) -> np.ndarray:
    """Render one textured planar quad (corners in OBJECT frame, CCW as seen
    from the textured side) under pose x_cam = R @ X_obj + T, z-buffered into
    (canvas, depth_buf) in place. Returns the quad's visibility mask (bool).

    The planar homography maps the square texture onto the projected quad;
    depth is analytic from the quad's supporting plane (n.X = c in camera
    frame => lambda = c / (n . K^-1 p) per pixel). With ``cull`` (solid
    faces), backfacing quads are skipped; with ``cull=False`` (thin textured
    sheets like SyntheticObject planes), the same homography renders from
    either side — the appearance seen from behind is the texture's mirror
    image, exactly like a slide held up to the light."""
    h, w = hw
    cam = corners_obj @ R.T + T                                   # (4,3)
    if (cam[:, 2] <= 0.05).any():
        return np.zeros((h, w), bool)

    # supporting plane in camera frame
    n_obj = np.cross(corners_obj[1] - corners_obj[0],
                     corners_obj[3] - corners_obj[0])
    n_cam = R @ (n_obj / (np.linalg.norm(n_obj) + 1e-12))
    c_cam = float(n_cam @ cam[0])
    if cull and c_cam >= 0:   # normal points away from the camera => backface
        return np.zeros((h, w), bool)

    pix = cam @ K.T
    pix = pix[:, :2] / pix[:, 2:3]
    ts = texture.shape[0]
    src = np.array([[0, 0], [ts - 1, 0], [ts - 1, ts - 1], [0, ts - 1]],
                   np.float32)
    H = raster.get_perspective_transform(src, pix.astype(np.float32))

    # Depth/visibility math only inside the projected-corner bounding box:
    # the warped mask is zero outside the projected quad, which lies in the
    # convex hull of ``pix`` (all corners are in front — checked above), so
    # out-of-ROI pixels can never be visible. The warps are computed on the
    # ROI alone too: each warped pixel depends only on its own position.
    u0 = max(0, int(np.floor(pix[:, 0].min())) - 2)
    u1 = min(w, int(np.ceil(pix[:, 0].max())) + 3)
    v0 = max(0, int(np.floor(pix[:, 1].min())) - 2)
    v1 = min(h, int(np.ceil(pix[:, 1].max())) + 3)
    if u0 >= u1 or v0 >= v1:
        return np.zeros((h, w), bool)
    roi = (slice(v0, v1), slice(u0, u1))
    warped = raster.warp_perspective(texture, H, (w, h), roi=roi)
    mask = raster.warp_perspective(np.full((ts, ts), 255, np.uint8), H,
                                   (w, h), nearest=True, roi=roi)

    rays_cam = _pixel_rays(K, hw)[roi]
    denom = rays_cam @ n_cam
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = np.where(np.abs(denom) > 1e-9, c_cam / denom, 0.0)
    db_roi = depth_buf[roi]
    vis_roi = (mask > 0) & (depth > 0.05) & (
        (db_roi == 0) | (depth < db_roi))
    canvas[roi] = np.where(vis_roi, warped, canvas[roi])
    depth_buf[roi] = np.where(vis_roi, depth.astype(np.float32), db_roi)
    visible = np.zeros((h, w), bool)
    visible[roi] = vis_roi
    return visible


def render_plane(texture: np.ndarray, size_m: float, R: np.ndarray,
                 T: np.ndarray, K: np.ndarray, hw: Tuple[int, int],
                 canvas: Optional[np.ndarray] = None,
                 depth_buf: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render a textured square plane (object frame: [-s/2, s/2]^2 at z=0)
    under pose x_cam = R @ X_obj + T. Z-buffered into (canvas, depth_buf).

    Returns (canvas u8 gray, depth f32 meters with 0=invalid, mask u8)."""
    h, w = hw
    if canvas is None:
        canvas = np.zeros((h, w), np.uint8)
    if depth_buf is None:
        depth_buf = np.zeros((h, w), np.float32)
    s = size_m / 2.0
    corners_obj = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]],
                           np.float64)
    # cull=False: a plane is a thin textured sheet, visible from both sides
    # through the SAME homography (round-1/2 behavior preserved exactly)
    visible = render_quad(texture, corners_obj, R, T, K, hw, canvas,
                          depth_buf, cull=False)
    return canvas, depth_buf, (visible * 255).astype(np.uint8)


@dataclasses.dataclass
class SyntheticObject:
    """A textured square plane — the round-1/2 evaluation object."""

    object_id: str
    texture: np.ndarray
    size_m: float = 0.24

    @classmethod
    def make(cls, object_id: str, seed: int, size_m: float = 0.24):
        return cls(object_id, make_texture(seed), size_m)

    def render(self, R: np.ndarray, T: np.ndarray, K: np.ndarray,
               hw: Tuple[int, int], canvas=None, depth_buf=None):
        return render_plane(self.texture, self.size_m, R, T, K, hw,
                            canvas, depth_buf)


@dataclasses.dataclass
class SyntheticBox:
    """A textured axis-aligned box (object frame: centered at the origin,
    extents ``size_m``) with a DISTINCT texture per face — the non-planar
    domain the reference actually targets (turntable captures of 3D household
    objects, Trainer.cpp:121-187): self-occlusion in every view, multi-view
    model merging across faces, rank-3 model point sets."""

    object_id: str
    textures: List[np.ndarray]               # 6 face textures (+x,-x,+y,-y,+z,-z)
    size_m: Tuple[float, float, float] = (0.16, 0.12, 0.08)

    @classmethod
    def make(cls, object_id: str, seed: int,
             size_m: Tuple[float, float, float] = (0.16, 0.12, 0.08)):
        return cls(object_id,
                   [make_texture(seed * 7 + f, size=256) for f in range(6)],
                   size_m)

    def _faces(self) -> List[np.ndarray]:
        sx, sy, sz = (s / 2.0 for s in self.size_m)
        # each face CCW as seen from OUTSIDE (outward normal via
        # cross(c1-c0, c3-c0))
        return [np.array(f, np.float64) for f in (
            [( sx, -sy, -sz), ( sx,  sy, -sz), ( sx,  sy,  sz), ( sx, -sy,  sz)],   # +x
            [(-sx,  sy, -sz), (-sx, -sy, -sz), (-sx, -sy,  sz), (-sx,  sy,  sz)],   # -x
            [( sx,  sy, -sz), (-sx,  sy, -sz), (-sx,  sy,  sz), ( sx,  sy,  sz)],   # +y
            [(-sx, -sy, -sz), ( sx, -sy, -sz), ( sx, -sy,  sz), (-sx, -sy,  sz)],   # -y
            [(-sx, -sy,  sz), ( sx, -sy,  sz), ( sx,  sy,  sz), (-sx,  sy,  sz)],   # +z
            [(-sx,  sy, -sz), ( sx,  sy, -sz), ( sx, -sy, -sz), (-sx, -sy, -sz)],   # -z
        )]

    def render(self, R: np.ndarray, T: np.ndarray, K: np.ndarray,
               hw: Tuple[int, int], canvas=None, depth_buf=None):
        h, w = hw
        if canvas is None:
            canvas = np.zeros((h, w), np.uint8)
        if depth_buf is None:
            depth_buf = np.zeros((h, w), np.float32)
        visible = np.zeros((h, w), bool)
        for tex, quad in zip(self.textures, self._faces()):
            visible |= render_quad(tex, quad, R, T, K, hw, canvas, depth_buf)
        return canvas, depth_buf, (visible * 255).astype(np.uint8)


@dataclasses.dataclass
class SyntheticCylinder:
    """A textured cylinder (object frame: axis = z, centered at the origin):
    CURVED geometry — every view's model points span rank 3, surface normals
    vary continuously, and the silhouette self-occludes. Rendered by
    analytic per-pixel ray casting (side + end caps)."""

    object_id: str
    side_texture: np.ndarray
    cap_texture: np.ndarray
    radius_m: float = 0.06
    height_m: float = 0.18

    @classmethod
    def make(cls, object_id: str, seed: int, radius_m: float = 0.06,
             height_m: float = 0.18):
        return cls(object_id, make_texture(seed * 11 + 3, size=384),
                   make_texture(seed * 11 + 5, size=256), radius_m, height_m)

    def render(self, R: np.ndarray, T: np.ndarray, K: np.ndarray,
               hw: Tuple[int, int], canvas=None, depth_buf=None):
        h, w = hw
        if canvas is None:
            canvas = np.zeros((h, w), np.uint8)
        if depth_buf is None:
            depth_buf = np.zeros((h, w), np.float32)
        r, hh = self.radius_m, self.height_m / 2.0

        # Restrict the per-pixel ray casting to the projected bounding box
        # of the cylinder's object-frame AABB corners: any in-front hit lies
        # on the cylinder, whose projection is inside the convex hull of the
        # projected corners — pixels outside it can never satisfy ``ok``.
        # Per-pixel math is elementwise, so the ROI result is bitwise
        # identical to the full-frame computation (which the render was
        # before; full-frame f64 ray math dominated 1-CPU training time).
        corners = np.array([[sx * r, sy * r, sz * hh]
                            for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], np.float64)
        cam = corners @ R.T + T
        if (cam[:, 2] > 0.05).all():
            pix = cam @ K.T
            pix = pix[:, :2] / pix[:, 2:3]
            u0 = max(0, int(np.floor(pix[:, 0].min())) - 2)
            u1 = min(w, int(np.ceil(pix[:, 0].max())) + 3)
            v0 = max(0, int(np.floor(pix[:, 1].min())) - 2)
            v1 = min(h, int(np.ceil(pix[:, 1].max())) + 3)
            if u0 >= u1 or v0 >= v1:     # fully off-screen: nothing to hit
                return canvas, depth_buf, np.zeros((h, w), np.uint8)
        else:                            # near/behind camera: full frame
            u0, u1, v0, v1 = 0, w, 0, h
        roi = (slice(v0, v1), slice(u0, u1))
        rh, rw = v1 - v0, u1 - u0

        # rays in OBJECT frame: o + t*d with o = -R^T T, d = R^T K^-1 p
        d_cam = _pixel_rays(K, hw)[roi]                         # (rh,rw,3)
        d = d_cam @ R                                           # R^T applied
        o = -(R.T @ T)                                          # (3,)
        best_t = np.full((rh, rw), np.inf)
        shade = np.zeros((rh, rw), np.uint8)

        # side: (ox+t*dx)^2 + (oy+t*dy)^2 = r^2, z within [-hh, hh]
        a = d[..., 0] ** 2 + d[..., 1] ** 2
        b = 2 * (o[0] * d[..., 0] + o[1] * d[..., 1])
        c = o[0] ** 2 + o[1] ** 2 - r * r
        disc = b * b - 4 * a * c
        with np.errstate(invalid="ignore", divide="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            for sign in (-1.0, 1.0):        # near hit first, far as fallback
                t = (-b + sign * sq) / (2 * a)
                z = o[2] + t * d[..., 2]
                lam = t * d_cam[..., 2]     # camera-frame depth of the hit
                ok = (disc > 0) & (t > 0) & (np.abs(z) <= hh) \
                    & (lam > 0.05) & (t < best_t)
                if ok.any():
                    u = (np.arctan2(o[1] + t * d[..., 1],
                                    o[0] + t * d[..., 0]) / (2 * np.pi)
                         + 0.5)
                    v = (z + hh) / (2 * hh)
                    ts = self.side_texture.shape
                    ui = np.clip((u * (ts[1] - 1)).astype(np.int32), 0,
                                 ts[1] - 1)
                    vi = np.clip((v * (ts[0] - 1)).astype(np.int32), 0,
                                 ts[0] - 1)
                    shade = np.where(ok, self.side_texture[vi, ui], shade)
                    best_t = np.where(ok, t, best_t)

        # end caps: z = +-hh discs of radius r
        for zc in (hh, -hh):
            with np.errstate(invalid="ignore", divide="ignore"):
                t = (zc - o[2]) / d[..., 2]
            x = o[0] + t * d[..., 0]
            y = o[1] + t * d[..., 1]
            lam = t * d_cam[..., 2]
            ok = (np.abs(d[..., 2]) > 1e-9) & (t > 0) \
                & (x * x + y * y <= r * r) & (lam > 0.05) & (t < best_t)
            if ok.any():
                ts = self.cap_texture.shape
                ui = np.clip(((x / r * 0.5 + 0.5)
                              * (ts[1] - 1)).astype(np.int32), 0, ts[1] - 1)
                vi = np.clip(((y / r * 0.5 + 0.5)
                              * (ts[0] - 1)).astype(np.int32), 0, ts[0] - 1)
                shade = np.where(ok, self.cap_texture[vi, ui], shade)
                best_t = np.where(ok, t, best_t)

        depth = np.where(np.isfinite(best_t), best_t * d_cam[..., 2], 0.0)
        db_roi = depth_buf[roi]
        visible = (depth > 0.05) & ((db_roi == 0) | (depth < db_roi))
        canvas[roi] = np.where(visible, shade, canvas[roi])
        depth_buf[roi] = np.where(visible, depth.astype(np.float32), db_roi)
        mask = np.zeros((h, w), np.uint8)
        mask[roi] = visible * 255
        return canvas, depth_buf, mask


def turntable_observations(obj, n_views: int = 12,
                           distance: float = 0.8,
                           elevations_deg: Sequence[float] = (65.0, 40.0),
                           hw: Tuple[int, int] = (480, 640),
                           K: np.ndarray = DEFAULT_K) -> List[Dict]:
    """Orbit a camera around the object (object frame == world frame) and
    render observations in the trainer's expected format.

    ``obj`` is any synthetic object exposing ``render(R, T, K, hw, ...)``
    (plane / box / cylinder). ``n_views`` azimuth steps per elevation ring;
    multiple rings give the viewpoint coverage a real turntable capture
    provides (the reference's ~36-view captures, SURVEY.md section 3.1)."""
    out = []
    frame = 0
    for el_deg in elevations_deg:
        el = np.radians(el_deg)
        for v in range(n_views):
            az = 2 * np.pi * v / n_views
            c = distance * np.array([np.cos(az) * np.cos(el),
                                     np.sin(az) * np.cos(el),
                                     np.sin(el)])
            R, T = look_at(c, np.zeros(3))
            canvas, depth, mask = obj.render(R, T, K, hw)
            image = np.repeat(canvas[..., None], 3, axis=-1)
            depth_u16 = np.round(depth * 1000).astype(np.uint16)
            out.append(dict(image=image, depth=depth_u16, mask=mask, K=K,
                            R=R, T=T, frame_number=frame))
            frame += 1
    return out


def compose_scene(objects: Sequence,
                  poses: Sequence[Tuple[np.ndarray, np.ndarray]],
                  hw: Tuple[int, int] = (480, 640),
                  K: np.ndarray = DEFAULT_K,
                  background_seed: int = 99,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Render several objects (planes / boxes / cylinders) at given
    model->camera poses into one z-buffered RGB-D frame.
    Returns (image (H,W,3) u8, depth u16 mm with 0=invalid)."""
    h, w = hw
    rngb = np.random.default_rng(background_seed)
    canvas = rngb.integers(90, 110, (h, w), np.uint8)
    canvas = raster.gaussian_blur_u8(canvas, 5, 3.0)
    depth_buf = np.zeros((h, w), np.float32)
    for obj, (R, T) in zip(objects, poses):
        canvas, depth_buf, _ = obj.render(R, T, K, hw, canvas, depth_buf)
    image = np.repeat(canvas[..., None], 3, axis=-1)
    depth_u16 = np.round(depth_buf * 1000).astype(np.uint16)
    return image, depth_u16


def degrade_frame(image: np.ndarray, depth_u16: np.ndarray,
                  rng: np.random.Generator, *,
                  rgb_sigma: float = 6.0,
                  depth_sigma_mm: float = 3.0,
                  depth_dropout: float = 0.05,
                  n_occluders: int = 0,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Degrade a clean rendered RGB-D frame with a structured-light-sensor
    noise model, for robustness evaluation (the reference's real inputs are
    Kinect captures, not clean renders):

    - RGB: additive Gaussian (``rgb_sigma`` grey levels) on the luminance,
      identical across channels (the renderer is greyscale-replicated).
    - Depth: additive Gaussian whose sigma grows quadratically with range —
      ``depth_sigma_mm * z_m**2`` — the standard structured-light axial
      noise law (Khoshelham & Elberink 2012); applied only to valid pixels.
    - Speckle dropout: a ``depth_dropout`` fraction of valid depth pixels
      set to 0 (invalid), as around specular/oblique surfaces.
    - Occluders: ``n_occluders`` textured rectangles pasted at ~0.4-0.55 m,
      in front of every bench object, occluding whatever is behind them.

    Ground truth is unchanged: the degraded frame keeps the same object
    poses. Deterministic given ``rng``."""
    img = image.astype(np.float32)
    if rgb_sigma > 0:
        noise = rng.normal(0.0, rgb_sigma, img.shape[:2]).astype(np.float32)
        img = img + noise[..., None]
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)

    depth = depth_u16.astype(np.float32)
    valid = depth > 0
    if depth_sigma_mm > 0:
        z_m = depth / 1000.0
        sigma = depth_sigma_mm * z_m * z_m
        depth = np.where(
            valid, depth + rng.normal(size=depth.shape) * sigma, 0.0)
    if depth_dropout > 0:
        drop = rng.random(depth.shape) < depth_dropout
        depth = np.where(drop, 0.0, depth)
    depth_u16 = np.clip(np.round(depth), 0, 65535).astype(np.uint16)

    for _ in range(n_occluders):
        h, w = img.shape[:2]
        ow = int(rng.integers(60, 140))
        oh = int(rng.integers(60, 140))
        x0 = int(rng.integers(0, w - ow))
        y0 = int(rng.integers(0, h - oh))
        z_occ = float(rng.uniform(0.40, 0.55))
        tex = make_texture(int(rng.integers(1 << 30)), size=160)
        patch = raster.resize_linear(tex, (ow, oh))
        img[y0:y0 + oh, x0:x0 + ow] = patch[..., None]
        depth_u16[y0:y0 + oh, x0:x0 + ow] = np.uint16(round(z_occ * 1000))
    return img, depth_u16


def presenting_pose(rng: np.random.Generator, z: float = 0.8,
                    max_tilt: float = 0.5,
                    xy_extent: float = 0.18) -> Tuple[np.ndarray, np.ndarray]:
    """A random model->camera pose presenting the object's +z side — the
    side a turntable capture actually trains (cameras orbit ABOVE the
    object) — to the camera: ``facing_pose``'s tilt composed with a pi flip
    about x so object +z maps near camera -z. Use this for SOLID objects
    (boxes/cylinders): ``facing_pose`` at small tilt shows a solid's
    never-trained bottom face."""
    R, T = facing_pose(rng, z, max_tilt, xy_extent)
    return R @ np.diag([1.0, -1.0, -1.0]), T


def facing_pose(rng: np.random.Generator, z: float = 0.8,
                max_tilt: float = 0.5,
                xy_extent: float = 0.18) -> Tuple[np.ndarray, np.ndarray]:
    """A random model->camera pose with the plane roughly facing the camera."""
    ax = rng.uniform(-max_tilt, max_tilt)
    ay = rng.uniform(-max_tilt, max_tilt)
    az = rng.uniform(-np.pi, np.pi)
    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        m = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c; m[j, j] = c; m[i, j] = -s; m[j, i] = s
        return m
    R = rot(0, ax) @ rot(1, ay) @ rot(2, az)
    T = np.array([rng.uniform(-xy_extent, xy_extent),
                  rng.uniform(-xy_extent, xy_extent),
                  z + rng.uniform(-0.1, 0.1)])
    return R, T
