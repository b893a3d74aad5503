"""Wavefront path tracer: fixed-depth bounce scan + reverse shading fold.

The reference traces each pixel with a recursive-iterator bounce loop
(``RaytraceIterator::next``, reference src/rt.rs:1014-1066) and then
folds the collected path back-to-front in ``reduce_light`` (rt.rs:956-994).
Here it is the same computation over a *batch* of rays:

* forward: ``lax.scan`` of length ``bounce+1`` carrying ray SoA state with a
  live mask (no early exit — dead lanes are masked), emitting one per-bounce
  hit record;
* backward: ``lax.scan(reverse=True)`` over the records implementing the
  reverse fold, including the stochastic emit termination and the exact
  shading constants (80% dielectric diffuse, 0.85 refraction cap, 0.5
  indirect, spec^32, eta = 1 + 0.5*glass, pwr decay 1-loss).

Everything is differentiable w.r.t. the scene's float leaves; stochastic
branch *choices* are comparisons (no gradient path), while the chosen values
carry gradients — the standard detached-control estimator.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..ops import intersect, linalg, rng
from ..ops.linalg import EPS
from .compiler import CameraArrays, SceneArrays
from . import camera as camera_mod
from . import schema


def _closest_hit(scene, frames, o, d, tri_pack=None):
    """Closest hit of each ray: the dense (rays x rows) sweep."""
    return intersect.closest_hit(scene, frames, o, d,
                                 need_exit=scene.any_refract,
                                 tri_pack=tri_pack)


def _any_hit(scene, frames, o, d, tri_pack=None):
    """Occlusion query for shadow rays (boolean, gradient-free)."""
    return intersect.any_hit(scene, frames, o, d, tri_pack=tri_pack)


def _resort_on(scene: SceneArrays) -> bool:
    """Whether to re-sort rays between bounce steps (see _resort_perm).

    ``MRT_RESORT=1`` turns it on; the default is off. Radiance is
    bitwise-identical either way (each ray keeps its uniform stream), so
    it is pure scheduling; it has not been measured on a GPU.
    """
    return os.environ.get("MRT_RESORT", "0") == "1"


def _resort_perm(ox, oy, oz, dx, dy, dz, live):
    """Lane permutation restoring wavefront coherence mid-trace.

    Sort key: live rays first, ordered by Morton cell of the ray origin
    inside the live wavefront's bounding box (8^3 grid) then direction
    octant; dead rays last. Applied between bounce steps, it keeps
    neighbouring lanes spatially close after diffuse bounces scatter the
    rays the camera laid out coherently. The reference never needs this:
    its per-ray recursion (rt.rs:1014-1066) has no lanes to keep together.

    All inputs are (R,) vectors; returns an int32 (R,) permutation,
    stable within equal keys.
    """
    alive = live > 0.5
    big = jnp.float32(3.4e38)

    def axis_cell(v):
        lo = jnp.min(jnp.where(alive, v, big))
        hi = jnp.max(jnp.where(alive, v, -big))
        span = jnp.maximum(hi - lo, 1e-6)
        c = ((v - lo) / span * 8.0).astype(jnp.int32)
        return jnp.clip(c, 0, 7)

    def spread3(v):  # 3-bit value -> bits at positions 0, 3, 6
        return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4)

    morton = (spread3(axis_cell(ox)) | (spread3(axis_cell(oy)) << 1)
              | (spread3(axis_cell(oz)) << 2))
    octant = ((dx > 0).astype(jnp.int32) * 4 + (dy > 0).astype(jnp.int32) * 2
              + (dz > 0).astype(jnp.int32))
    key = jnp.where(alive, morton * 8 + octant, jnp.int32(1 << 30))
    return jnp.argsort(key, stable=True).astype(jnp.int32)


def _light_dirs_to(scene: SceneArrays, point):
    """Un-normalized vector toward each light from ``point`` (rt.rs:975-978).

    point: (R,3) -> (R,L,3). For directional lights the vector is
    ``-normalize(dir)`` independent of position.
    """
    lp = scene.light_pos[None] - point[:, None, :]             # (R,L,3)
    ld = -linalg.normalize(scene.light_dir)[None]               # (1,L,3)
    return jnp.where(scene.light_is_dir[None, :, None], ld, lp)


def _bounce_step(scene: SceneArrays, frames, attrs, decay, key, carry, i,
                 tri_pack=None, u=None):
    """One wavefront bounce: closest hit, shadow rays, reflect/refract pick.

    Shared between the record-emitting path (:func:`trace_records`) and the
    fused-shading path (:func:`trace_fused`); semantics per rt.rs:1014-1066.
    Returns ``(new_carry, rec)`` where ``rec`` holds this bounce's shading
    inputs.
    """
    o, d, pwr, live = carry
    R = o.shape[0]
    P = scene.n_prims
    L = scene.n_lights
    hit = _closest_hit(scene, frames, o, d, tri_pack=tri_pack)
    live_i = live & hit.hit

    # Winner attributes arrive in one fetch each (entry and exit) instead
    # of ~30 per-ray gathers (see intersect.fetch_attrs).
    at_e = intersect.fetch_attrs(attrs, hit.idx_entry, P)

    # Keep dead lanes finite so no NaNs leak into gradients.
    te = jnp.where(live_i, hit.t_entry, 1.0)
    entry_p = o + d * te[:, None]
    n_entry = intersect.normal_from_attrs(at_e, entry_p)
    n_entry = jnp.where(jnp.isfinite(n_entry), n_entry, 0.0)
    mat_e = intersect.material_from_attrs(scene, at_e, entry_p)

    # The exit hit only matters for refraction (rt.rs:1054-1058); fully
    # opaque scenes (static any_refract=False) compile without it.
    if scene.any_refract:
        at_x = intersect.fetch_attrs(attrs, hit.idx_exit, P)
        tx = jnp.where(live_i, hit.t_exit, 1.0)
        exit_p = o + d * tx[:, None]
        n_exit = intersect.normal_from_attrs(at_x, exit_p)
        n_exit = jnp.where(jnp.isfinite(n_exit), n_exit, 0.0)
        mat_x = intersect.material_from_attrs(scene, at_x, exit_p)

    if u is None:
        u = rng.uniform(jax.random.fold_in(key, i), (R, 7))

    # per-light shadow rays from the entry hit (rt.rs:1027-1046)
    if L > 0:
        lvec = _light_dirs_to(scene, entry_p)               # (R,L,3)
        ldir = linalg.normalize(lvec)
        sorig = entry_p[:, None, :] + ldir * EPS            # Ray::cast_default
        occ = _any_hit(scene, frames,
                       sorig.reshape(R * L, 3),
                       ldir.reshape(R * L, 3),
                       tri_pack=tri_pack).reshape(R, L)
        light_ok = (~occ) & live_i[:, None]
    else:
        light_ok = jnp.zeros((R, 0), bool)

    # reflect from the entry hit (rt.rs:559-572)
    diel_e = (mat_e["metal_scalar"] == 0.0) & (mat_e["opacity"] != 0.0)
    rough_r = jnp.where(diel_e & (u[:, 0] < 0.8), 1.0, mat_e["rough"])
    nr = rng.sphere_rand(n_entry, rough_r, u[:, 1], u[:, 2])
    refl = linalg.safe_normalize(linalg.reflect(d, nr))

    if scene.any_refract:
        # refract from the exit hit (rt.rs:574-589, 1054-1058)
        diel_x = (mat_x["metal_scalar"] == 0.0) & (mat_x["opacity"] != 0.0)
        rough_f = jnp.where(diel_x & (u[:, 3] < 0.8), 1.0, mat_x["rough"])
        nf = rng.sphere_rand(n_exit, rough_f, u[:, 4], u[:, 5])
        eta = 1.0 + 0.5 * mat_x["glass"]
        refr, refr_ok = linalg.refract(d, eta, nf)
        refr = linalg.safe_normalize(refr)
        refr = jnp.where(jnp.isfinite(refr), refr, 0.0)
        choose = (u[:, 6] < jnp.minimum(1.0 - mat_e["opacity"], 0.85)) & refr_ok

        next_dir = jnp.where(choose[:, None], refr, refl)
        from_p = jnp.where(choose[:, None], exit_p, entry_p)
        pick = lambda a, b: jnp.where(
            choose[:, None] if a.ndim == 2 else choose, a, b)
        norm = pick(n_exit, n_entry)
        color = pick(mat_x["color"], mat_e["color"])
        rough = pick(mat_x["rough"], mat_e["rough"])
        metal = pick(mat_x["metal"], mat_e["metal"])
        emit = pick(mat_x["emit"], mat_e["emit"])
    else:
        # opaque scene: `choose` is always False (opacity==1 everywhere,
        # rt.rs:1054's probability is min(1-1, 0.85)=0)
        next_dir = refl
        from_p = entry_p
        norm, color = n_entry, mat_e["color"]
        rough, metal, emit = mat_e["rough"], mat_e["metal"], mat_e["emit"]

    next_orig = from_p + next_dir * EPS                     # Ray::cast
    next_pwr = pwr * decay

    rec = {
        "live": live_i,
        "p": from_p,
        "norm": norm,
        "dir": d,
        "pwr": pwr,
        "color": color,
        "rough": rough,
        "metal": metal,
        "emit": emit,
        "light_ok": light_ok,
    }
    return (next_orig, next_dir, next_pwr, live_i), rec


def _direct_light(scene: SceneArrays, rec):
    """Per-bounce direct-light term of ``reduce_light`` (rt.rs:973-987).

    ``rec`` needs p/norm/dir/rough/metal/color/light_ok; returns (R,3).
    Uses the *chosen* hit point but the entry-point shadow mask — the
    reference quirk (shadow rays cast from p0, shading from use_p).
    """
    R = rec["p"].shape[0]
    if scene.n_lights == 0:
        return jnp.zeros((R, 3), rec["p"].dtype)
    lvec = _light_dirs_to(scene, rec["p"])                      # (R,L,3)
    ln = linalg.normalize(lvec)
    diff = jnp.maximum(linalg.dot(ln, rec["norm"][:, None, :]), 0.0)
    spec = jax.lax.integer_pow(
        jnp.maximum(linalg.dot(rec["dir"][:, None, :],
                               linalg.reflect(ln, rec["norm"][:, None, :])),
                    0.0), 32) * (1.0 - rec["rough"][:, None])
    o_col = (rec["color"] * (1.0 - rec["metal"])[:, None])[:, None, :]
    contrib = (o_col * diff[..., None] * scene.light_color[None]
               + spec[..., None]) * scene.light_pwr[None, :, None]
    return jnp.sum(jnp.where(rec["light_ok"][..., None], contrib, 0.0),
                   axis=1)


def trace_records(scene: SceneArrays, frames, attrs, bounce: int,
                  orig, dirs, loss, key, remat: bool = False,
                  tri_pack=None):
    """Run the forward bounce loop, returning stacked per-bounce records.

    Args:
      scene: compiled scene.
      frames: (P,3,3) instance matrices.
      attrs: (P,K) packed attribute matrix (:func:`intersect.prim_attributes`).
      bounce: static max bounce (path length = bounce+1 records).
      orig, dirs: (R,3) primary rays (E-offset origins).
      loss: scalar energy loss per bounce.
      key: PRNG key; draws are fold_in(key, step).
      remat: checkpoint each step (for memory-lean gradients).
    Returns:
      dict of records with leading axis ``bounce+1``.
    """
    R = orig.shape[0]
    decay = 1.0 - jnp.minimum(loss, 1.0)

    def step(carry, i):
        return _bounce_step(scene, frames, attrs, decay, key, carry, i,
                            tri_pack=tri_pack)

    step_fn = jax.checkpoint(step) if remat else step
    init = (orig, dirs, jnp.ones((R,), orig.dtype), jnp.ones((R,), bool))
    _, records = jax.lax.scan(step_fn, init, jnp.arange(bounce + 1))
    return records


def _fold_update(scene: SceneArrays, rec, A, B, u_emit):
    """One forward composition step of the affine shading fold.

    ``col = A (.) col_tail + B``; per bounce B += A*b, A *= a with
    a/b per rt.rs:966-992 (see trace_fused). Returns (A2, B2).
    """
    live = rec["live"]
    b_emit = u_emit < rec["emit"]                           # rt.rs:966-970
    l_col = _direct_light(scene, rec)
    pwr_c = rec["pwr"][:, None]
    a = jnp.where(b_emit[:, None], 0.0, pwr_c * (0.5 + rec["color"]))
    b = jnp.where(b_emit[:, None], rec["color"], pwr_c * l_col)
    a = jnp.where(live[:, None], a, 1.0)
    b = jnp.where(live[:, None], b, 0.0)
    return A * a, B + A * b


def fused_step_reference(scene: SceneArrays, frames, attrs, decay,
                         ray, A, B, u, u_emit, tri_pack=None):
    """One full fused bounce step from explicit uniforms (no RNG inside).

    The scan body of :func:`trace_fused` with its uniforms injected, so
    tests can drive one bounce deterministically.
    Returns (ray2, A2, B2, live2).
    """
    ray2, rec = _bounce_step(scene, frames, attrs, decay, None, ray, 0,
                             tri_pack=tri_pack, u=u)
    A2, B2 = _fold_update(scene, rec, A, B, u_emit)
    return ray2, A2, B2, rec["live"]


def trace_fused(scene: SceneArrays, frames, attrs, bounce: int,
                orig, dirs, loss, key_trace, key_shade,
                remat: bool = False, tri_pack=None):
    """Forward bounce loop with the shading fold composed *forward*.

    ``reduce_light`` (rt.rs:956-994) is an affine recurrence in the radiance:
    ``col_i = a_i (.) col_{i+1} + b_i`` with per-bounce coefficients

      a_i = [live] * [not emit] * pwr_i * (0.5 + color_i)
      b_i = [live] * where(emit, color_i, pwr_i * l_col_i)

    (dead lanes pass through: a=1, b=0). Composing the maps front-to-back —
    carry (A, B) with ``col = A (.) col_tail + B``; per bounce B += A*b,
    A *= a — yields the identical radiance WITHOUT materializing the
    per-bounce record stack that the reverse scan re-reads from HBM. Same
    RNG draws as trace_records+shade_records (fold_in(key_shade, i) for the
    emit test), so results match the record path up to float reassociation.
    """
    R = orig.shape[0]
    decay = 1.0 - jnp.minimum(loss, 1.0)
    steps = bounce + 1
    resort = _resort_on(scene)

    def step(carry, i):
        ray, A, B, first_live, rid = carry
        u = rng.uniform(jax.random.fold_in(key_trace, i), (R, 7))
        u_emit = rng.uniform(jax.random.fold_in(key_shade, i), (R,))
        if resort:
            u, u_emit = u[rid], u_emit[rid]
        ray2, A2, B2, live = fused_step_reference(
            scene, frames, attrs, decay, ray, A, B, u, u_emit,
            tri_pack=tri_pack)
        first_live = jnp.where(i == 0, live, first_live)
        if resort:
            o2, d2 = ray2[0], ray2[1]
            perm = _resort_perm(o2[:, 0], o2[:, 1], o2[:, 2],
                                d2[:, 0], d2[:, 1], d2[:, 2],
                                ray2[3].astype(o2.dtype))
            ray2 = tuple(a[perm] for a in ray2)
            A2, B2 = A2[perm], B2[perm]
            first_live, rid = first_live[perm], rid[perm]
        return (ray2, A2, B2, first_live, rid), None

    step_fn = jax.checkpoint(step) if remat else step
    init = ((orig, dirs, jnp.ones((R,), orig.dtype),
             jnp.ones((R,), bool)),
            jnp.ones((R, 3), orig.dtype), jnp.zeros((R, 3), orig.dtype),
            jnp.zeros((R,), bool), jnp.arange(R, dtype=jnp.int32))
    (_, A, B, first_live, rid), _ = jax.lax.scan(step_fn, init,
                                                 jnp.arange(steps))
    if resort:
        inv = jnp.zeros((R,), jnp.int32).at[rid].set(
            jnp.arange(R, dtype=jnp.int32))
        A, B, first_live = A[inv], B[inv], first_live[inv]
    base = jnp.broadcast_to(scene.sky_color * scene.sky_pwr, (R, 3))
    col = B + A * base
    # empty path -> bare sky color, *without* pwr (rt.rs:957-959)
    return jnp.where(first_live[:, None], col,
                     jnp.broadcast_to(scene.sky_color, (R, 3)))


def shade_records(scene: SceneArrays, records, key):
    """Reverse fold of ``reduce_light`` (rt.rs:956-994) over stacked records.

    Returns (R,3) radiance per primary ray.
    """
    n_steps, R = records["live"].shape
    L = scene.n_lights
    base = jnp.broadcast_to(scene.sky_color * scene.sky_pwr, (R, 3))

    def body(col, rec_i):
        rec, i = rec_i
        k = jax.random.fold_in(key, i)
        u_emit = rng.uniform(k, (R,))
        b_emit = u_emit < rec["emit"]                           # rt.rs:966-970

        if L > 0:
            lvec = _light_dirs_to(scene, rec["p"])              # (R,L,3)
            ln = linalg.normalize(lvec)
            diff = jnp.maximum(linalg.dot(ln, rec["norm"][:, None, :]), 0.0)
            spec = jax.lax.integer_pow(
                jnp.maximum(linalg.dot(rec["dir"][:, None, :],
                                       linalg.reflect(ln, rec["norm"][:, None, :])),
                            0.0), 32) * (1.0 - rec["rough"][:, None])
            o_col = (rec["color"] * (1.0 - rec["metal"])[:, None])[:, None, :]
            contrib = (o_col * diff[..., None] * scene.light_color[None]
                       + spec[..., None]) * scene.light_pwr[None, :, None]
            l_col = jnp.sum(jnp.where(rec["light_ok"][..., None], contrib, 0.0),
                            axis=1)                              # rt.rs:973-987
        else:
            l_col = jnp.zeros((R, 3), col.dtype)

        d_col = 0.5 * col + rec["color"] * col                   # rt.rs:990
        new = jnp.where(b_emit[:, None], rec["color"],
                        (d_col + l_col) * rec["pwr"][:, None])   # rt.rs:992
        return jnp.where(rec["live"][:, None], new, col), None

    col, _ = jax.lax.scan(body, base, (records, jnp.arange(n_steps)), reverse=True)
    # empty path -> bare sky color, *without* pwr (rt.rs:957-959)
    return jnp.where(records["live"][0][:, None], col,
                     jnp.broadcast_to(scene.sky_color, (R, 3)))


def trace_radiance(scene: SceneArrays, cam: CameraArrays, render_wh,
                   bounce: int, loss, coords, key, remat: bool = False,
                   fused: bool | None = None):
    """Full per-pixel radiance: camera rays -> bounce scan -> shading fold.

    One path per coordinate; the caller accumulates samples (the reference's
    ``Sampler::execute`` outer loop, sampler.rs:28-78). The shading fold runs
    fused into the forward scan by default (:func:`trace_fused` — no record
    stack in HBM); ``fused=False`` (or ``MRT_NO_FUSE=1``) selects the
    record-emitting two-scan path, which draws the same RNG stream and agrees
    up to float reassociation.
    """
    if fused is None:
        fused = os.environ.get("MRT_NO_FUSE", "0") != "1"
    k_cam, k_trace, k_shade = jax.random.split(key, 3)
    u_aprt = rng.uniform(k_cam, (coords.shape[0], 2))
    orig, dirs = camera_mod.gen_rays(cam, render_wh, coords, u_aprt)
    frames = intersect.build_frames(scene)
    attrs = intersect.prim_attributes(scene, frames)
    # hoist the per-triangle Woop constants out of the bounce scan
    tri_pack = None
    if intersect._use_tri_mxu(scene.kind_counts[schema.KIND_TRIANGLE]):
        tri_pack = intersect.triangle_pack(scene, frames)
    if fused:
        return trace_fused(scene, frames, attrs, bounce, orig, dirs,
                           loss, k_trace, k_shade, remat=remat,
                           tri_pack=tri_pack)
    records = trace_records(scene, frames, attrs, bounce, orig, dirs,
                            loss, k_trace, remat=remat, tri_pack=tri_pack)
    return shade_records(scene, records, k_shade)
