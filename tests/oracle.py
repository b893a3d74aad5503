"""Scalar reference oracle: a direct NumPy port of the reference's per-pixel
trace (reference src/rt.rs), used ONLY in tests to validate the
vectorized tracer against the original semantics in expectation.

Deliberately scalar and slow — structure mirrors rt.rs so discrepancies
localize: cast (rt.rs:900-931), closest_hit (867-898), RaytraceIterator
(1014-1066), reduce_light (956-994), Ray::reflect/refract (559-589),
RayTracer::rand (996-1007).
"""

from __future__ import annotations

import numpy as np

E = 1e-4


def norm(v):
    return v / np.linalg.norm(v)


def reflect3(v, n):
    return v - n * (2.0 * float(v @ n))


def refract3(v, eta, n):
    cos = -float(n @ v)
    k = 1.0 - eta * eta * (1.0 - cos * cos)
    if k < 0.0:
        return None
    return v * eta + n * (cos * eta + np.sqrt(k))


def rotate_y(dir4):
    w = dir4[0]
    cw = np.sqrt(max(1.0 - w * w, 0.0))
    return np.array([[cw, 0, w], [0, 1, 0], [-w, 0, cw]], np.float64)


def lookat(dir4):
    fwd = norm(dir4[1:4])
    up = np.array([0.0, 0.0, 1.0])
    right = norm(np.cross(fwd, up))
    n_up = np.cross(right, fwd)
    return np.array([
        [right[0], -right[1], right[2]],
        [-fwd[0], fwd[1], -fwd[2]],
        [n_up[0], -n_up[1], n_up[2]],
    ])


def inst_mat(dir4):
    neg = -np.asarray(dir4, np.float64)
    return rotate_y(neg) @ lookat(neg)


class Obj:
    def __init__(self, o):
        self.kind = o.kind
        self.geom = o.geometry
        self.mat = o.mat
        self.instances = [(np.asarray(p, np.float64), np.asarray(d, np.float64))
                          for p, d in o.instances]

    def intersect(self, M, ipos, o, d):
        """object-space intersect -> (t0, t1) or None (rt.rs:725-772)."""
        oo = ipos + M @ (o - ipos)
        dd = M @ d
        if self.kind == "sphere":
            r = float(self.geom["r"])
            oc = oo - ipos
            a = dd @ dd
            b = 2.0 * (oc @ dd)
            c = oc @ oc - r * r
            disc = b * b - 4 * a * c
            if disc < 0:
                return None
            sq = np.sqrt(disc)
            t0, t1 = (-b - sq) / (2 * a), (-b + sq) / (2 * a)
            if t0 < 0:
                return None
            return t0, t1
        if self.kind == "plane":
            n = norm(np.asarray(self.geom["n"], np.float64))
            dpl = -float(n @ ipos)
            dn = float(dd @ n)
            if dn == 0.0:
                return None
            t = -(float(oo @ n) + dpl) / dn
            if t <= 0:
                return None
            return t, t
        if self.kind == "box":
            m = np.empty(3)
            for i in range(3):
                m[i] = 1.0 / dd[i] if dd[i] != 0 else np.inf
                if np.isinf(m[i]):
                    m[i] = 1.0 / E
            nn = (oo - ipos) * m
            k = 0.5 * np.asarray(self.geom["sizes"], np.float64) * np.abs(m)
            t0 = np.max(-nn - k)
            t1 = np.min(-nn + k)
            if t0 > t1 or t1 < 0:
                return None
            return t0, t1
        # triangle / mesh handled by caller per-triangle
        raise AssertionError(self.kind)

    def tri_intersect(self, v0, v1, v2, oo, dd):
        e0, e1 = v1 - v0, v2 - v0
        pv = np.cross(dd, e1)
        det = float(e0 @ pv)
        if abs(det) < E:
            return None
        inv = 1.0 / det
        tv = oo - v0
        u = float(tv @ pv) * inv
        if u < 0 or u > 1:
            return None
        qv = np.cross(tv, e0)
        v = float(dd @ qv) * inv
        if v < 0 or u + v > 1:
            return None
        t = float(e1 @ qv) * inv
        if t < 0:
            return None
        return t

    def uv(self, M, ipos, p):
        """Texture coordinates at world point p (rt.rs:468-548)."""
        hp = ipos + M @ (p - ipos)
        if self.kind == "sphere":
            v = norm(hp - ipos)
            return (0.5 + 0.5 * np.arctan2(v[0], -v[1]) / np.pi,
                    0.5 - 0.5 * v[2])
        if self.kind == "plane":
            fx = (hp[0] + 0.5) - np.trunc(hp[0] + 0.5)
            fy = (hp[1] + 0.5) - np.trunc(hp[1] + 0.5)
            return (fx + 1.0 if fx < 0 else fx, fy + 1.0 if fy < 0 else fy)
        if self.kind == "box":
            sz = np.asarray(self.geom["sizes"], np.float64)
            q = (hp - ipos) * (2.0 / sz)
            if abs(q[0] - 1) < E:
                return ((0.5 + 0.5 * q[1]) / 4 + 2 / 4, (0.5 - 0.5 * q[2]) / 3 + 1 / 3)
            if abs(q[0] + 1) < E:
                return ((0.5 - 0.5 * q[1]) / 4, (0.5 - 0.5 * q[2]) / 3 + 1 / 3)
            if abs(q[1] - 1) < E:
                return ((0.5 - 0.5 * q[0]) / 4 + 3 / 4, (0.5 - 0.5 * q[2]) / 3 + 1 / 3)
            if abs(q[1] + 1) < E:
                return ((0.5 + 0.5 * q[0]) / 4 + 1 / 4, (0.5 - 0.5 * q[2]) / 3 + 1 / 3)
            if abs(q[2] - 1) < E:
                return ((0.5 + 0.5 * q[0]) / 4 + 1 / 4, (0.5 - 0.5 * q[1]) / 3)
            if abs(q[2] + 1) < E:
                return ((0.5 + 0.5 * q[0]) / 4 + 1 / 4, (0.5 + 0.5 * q[1]) / 3 + 2 / 3)
            return (0.0, 0.0)
        return (0.0, 0.0)  # triangles/meshes: todo!() in the reference

    @staticmethod
    def _texel(tex, u, v):
        h, w = tex.shape[:2]
        x = min(max(int(u * w), 0), w - 1)
        y = min(max(int(v * h), 0), h - 1)
        return np.asarray(tex[y, x], np.float64)

    def eval_mat(self, M, ipos, p):
        """Map-modulated material values at world point p (rt.rs:811-863)."""
        m = self.mat
        out = {"color": np.asarray(m.albedo, np.float64),
               "rough": float(m.rough), "metal": float(m.metal),
               "glass": float(m.glass), "opacity": float(m.opacity),
               "emit": float(m.emit)}
        maps = [m.tex, m.rmap, m.mmap, m.gmap, m.omap, m.emap]
        if not any(mp is not None for mp in maps):
            return out
        u, v = self.uv(M, ipos, p)
        if m.tex is not None:
            out["color"] = out["color"] * self._texel(m.tex, u, v)
        for mp, key in ((m.rmap, "rough"), (m.mmap, "metal"),
                        (m.gmap, "glass"), (m.omap, "opacity"),
                        (m.emap, "emit")):
            if mp is not None:
                out[key] = float(self._texel(mp, u, v)[0])
        return out

    def normal(self, M, ipos, p, tri_idx=None):
        hp = ipos + M @ (p - ipos)
        if self.kind == "sphere":
            n = hp - ipos
        elif self.kind == "plane":
            n = np.asarray(self.geom["n"], np.float64)
        elif self.kind == "box":
            sz = np.asarray(self.geom["sizes"], np.float64)
            q = (hp - ipos) * (2.0 / sz)
            n = np.zeros(3)
            if abs(q[0] - 1) < E:
                n = np.array([1.0, 0, 0])
            elif abs(q[0] + 1) < E:
                n = np.array([-1.0, 0, 0])
            elif abs(q[1] - 1) < E:
                n = np.array([0, 1.0, 0])
            elif abs(q[1] + 1) < E:
                n = np.array([0, -1.0, 0])
            # missing `else` quirk: z test can override (rt.rs:435)
            if abs(q[2] - 1) < E:
                n = np.array([0, 0, 1.0])
            elif abs(q[2] + 1) < E:
                n = np.array([0, 0, -1.0])
        elif self.kind in ("triangle", "mesh"):
            if self.kind == "triangle":
                v = np.asarray(self.geom["vtx"], np.float64)
            else:
                v = np.asarray(self.geom["mesh"], np.float64)[tri_idx]
            n = np.cross(v[1] - v[0], v[2] - v[0])
        m = M @ n
        return m / np.linalg.norm(m)


class Oracle:
    def __init__(self, cfg, rng=None):
        self.cfg = cfg
        self.objs = [Obj(o) for o in cfg.scene.objects]
        self.lights = cfg.scene.lights
        self.sky_color = np.asarray(cfg.scene.sky.color, np.float64)
        self.sky_pwr = float(cfg.scene.sky.pwr)
        self.rng = rng or np.random.default_rng(0)

    # rt.rs:867-898
    def closest_hit(self, o, d):
        best = None
        for obj in self.objs:
            for ipos, idir in obj.instances:
                M = inst_mat(idir)
                if obj.kind in ("triangle", "mesh"):
                    oo = ipos + M @ (o - ipos)
                    dd = M @ d
                    if obj.kind == "triangle":
                        tris = [np.asarray(obj.geom["vtx"], np.float64)]
                    else:
                        tris = list(np.asarray(obj.geom["mesh"], np.float64))
                    hits = []
                    for i, v in enumerate(tris):
                        t = self.tri_hit(obj, v, oo + 0*ipos, dd, ipos)
                        if t is not None:
                            hits.append((t, i))
                    if not hits:
                        continue
                    t0, i0 = min(hits)
                    t1, i1 = max(hits)
                    cand = (t0, t1, obj, ipos, M, i0, i1)
                else:
                    ts = obj.intersect(M, ipos, o, d)
                    if ts is None:
                        continue
                    cand = (ts[0], ts[1], obj, ipos, M, None, None)
                if best is None or cand[0] < best[0]:
                    best = cand
        return best

    def tri_hit(self, obj, v, oo, dd, ipos):
        return obj.tri_intersect(v[0] + ipos, v[1] + ipos, v[2] + ipos, oo, dd)

    # rt.rs:996-1007
    def rand_dir(self, n, rough):
        th = np.arccos(1.0 - 2.0 * self.rng.random())
        phi = self.rng.random() * 2 * np.pi
        v = np.array([np.sin(th) * np.cos(phi), np.sin(th) * np.sin(phi),
                      np.cos(th)])
        return norm(n + rough * v)

    def trace_pixel(self, x, y):
        cfg = self.cfg
        rt = cfg.rt
        cam = cfg.frame.cam
        w = cfg.frame.res[0] * cfg.frame.ssaa
        h = cfg.frame.res[1] * cfg.frame.ssaa
        aspect = w / h
        uv = np.array([aspect * (x - 0.5 * w) / w, (y - 0.5 * h) / h])

        tan_fov = np.tan(np.deg2rad(0.5 * cam.fov))
        d = norm(np.array([uv[0], 1.0 / (2 * tan_fov), -uv[1]]))
        o = np.asarray(cam.pos, np.float64) + d * E
        p = o + d * cam.foc
        pos = np.asarray(cam.pos, np.float64) + np.array([
            (self.rng.random() - 0.5) * cam.aprt, 0.0,
            (self.rng.random() - 0.5) * cam.aprt])
        nd = norm(p - pos)
        Mc = rotate_y(np.asarray(cam.dir, np.float64)) @ lookat(
            np.asarray(cam.dir, np.float64))
        d = Mc @ nd
        o = pos + d * E

        # forward bounce loop (rt.rs:1014-1066)
        path = []  # (point, norm, mats..., pwr, dir, lights_ok)
        pwr = 1.0
        bounce = 0
        while bounce <= rt.bounce:
            hit = self.closest_hit(o, d)
            if hit is None:
                break
            t0, t1, obj, ipos, M, i0, i1 = hit
            p0 = o + d * t0
            p1 = o + d * t1
            n0 = obj.normal(M, ipos, p0, i0)
            n1 = obj.normal(M, ipos, p1, i1)
            mat = obj.mat
            mat0 = obj.eval_mat(M, ipos, p0)
            mat1 = obj.eval_mat(M, ipos, p1)

            # shadow rays
            ok_lights = []
            for light in self.lights:
                if light.kind == "point":
                    l = np.asarray(light.pos, np.float64) - p0
                else:
                    l = -norm(np.asarray(light.dir, np.float64))
                ray_o = p0 + norm(l) * E
                if self.closest_hit(ray_o, norm(l)) is None:
                    ok_lights.append(light)

            # next ray: reflect from entry, maybe refract from exit.
            # NB: the dielectric gate reads the RAW mat.metal scalar but the
            # mapped opacity (RayHit::get_opacity), per rt.rs:563-566.
            rough = mat0["rough"]
            if mat.metal == 0.0 and mat0["opacity"] != 0.0 and self.rng.random() < 0.8:
                rough = 1.0
            nr = self.rand_dir(n0, rough)
            nd = norm(reflect3(d, nr))
            use_p, use_n, use_mat = p0, n0, mat0
            if self.rng.random() < min(1.0 - mat0["opacity"], 0.85):
                rough2 = mat1["rough"]
                if mat.metal == 0.0 and mat1["opacity"] != 0.0 and self.rng.random() < 0.8:
                    rough2 = 1.0
                nf = self.rand_dir(n1, rough2)
                eta = 1.0 + 0.5 * mat1["glass"]
                rr = refract3(d, eta, nf)
                if rr is not None:
                    nd = norm(rr)
                    use_p, use_n, use_mat = p1, n1, mat1

            path.append((use_p, use_n, use_mat, pwr, d.copy(), ok_lights))
            o = use_p + nd * E
            d = nd
            pwr *= (1.0 - min(rt.loss, 1.0))
            bounce += 1

        # reverse fold (rt.rs:956-994)
        if not path:
            return self.sky_color.copy()
        col = self.sky_color * self.sky_pwr
        for (p0, n0, emat, pwr, din, ok_lights) in reversed(path):
            albedo = emat["color"]
            if self.rng.random() < emat["emit"]:
                col = albedo.copy()
                continue
            l_col = np.zeros(3)
            for light in ok_lights:
                if light.kind == "point":
                    l = np.asarray(light.pos, np.float64) - p0
                else:
                    l = -norm(np.asarray(light.dir, np.float64))
                ln = norm(l)
                diff = max(float(ln @ n0), 0.0)
                spec = max(float(din @ reflect3(ln, n0)), 0.0) ** 32 \
                    * (1.0 - emat["rough"])
                o_col = albedo * (1.0 - emat["metal"])
                l_col = l_col + (o_col * diff * np.asarray(light.color, np.float64)
                                 + spec) * float(light.pwr)
            d_col = 0.5 * col + albedo * col
            col = (d_col + l_col) * pwr
        return col

    def _jitter(self, n, rough, u1, u2):
        """rand_dir with explicit uniforms (rt.rs:996-1007)."""
        th = np.arccos(1.0 - 2.0 * u1)
        phi = u2 * 2 * np.pi
        v = np.array([np.sin(th) * np.cos(phi), np.sin(th) * np.sin(phi),
                      np.cos(th)])
        return norm(n + rough * v)

    def step(self, o, d, pwr, u, u_emit):
        """One bounce of :meth:`trace_pixel` from explicit uniforms.

        ``u`` holds 7 uniforms in the vectorized tracer's order: dielectric
        gate and jitter (2) for the reflection, the same for the
        refraction, then the refraction choice; ``u_emit`` is the fold's
        emission draw. Returns ``(live, next_o, next_d, a, b)`` where the
        bounce's fold term is ``col = a * col_tail + b`` (rt.rs:956-994);
        a miss passes through (a = 1, b = 0).
        """
        o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
        hit = self.closest_hit(o, d)
        if hit is None:
            return False, None, None, np.ones(3), np.zeros(3)
        t0, t1, obj, ipos, M, i0, i1 = hit
        p0, p1 = o + d * t0, o + d * t1
        n0 = obj.normal(M, ipos, p0, i0)
        n1 = obj.normal(M, ipos, p1, i1)
        mat = obj.mat
        mat0 = obj.eval_mat(M, ipos, p0)
        mat1 = obj.eval_mat(M, ipos, p1)
        ok_lights = []
        for light in self.lights:
            if light.kind == "point":
                l = np.asarray(light.pos, np.float64) - p0
            else:
                l = -norm(np.asarray(light.dir, np.float64))
            if self.closest_hit(p0 + norm(l) * E, norm(l)) is None:
                ok_lights.append(light)

        rough = mat0["rough"]
        if mat.metal == 0.0 and mat0["opacity"] != 0.0 and u[0] < 0.8:
            rough = 1.0
        nd = norm(reflect3(d, self._jitter(n0, rough, u[1], u[2])))
        use_p, use_n, use_mat = p0, n0, mat0
        if u[6] < min(1.0 - mat0["opacity"], 0.85):
            rough2 = mat1["rough"]
            if mat.metal == 0.0 and mat1["opacity"] != 0.0 and u[3] < 0.8:
                rough2 = 1.0
            nf = self._jitter(n1, rough2, u[4], u[5])
            rr = refract3(d, 1.0 + 0.5 * mat1["glass"], nf)
            if rr is not None:
                nd = norm(rr)
                use_p, use_n, use_mat = p1, n1, mat1

        albedo = use_mat["color"]
        if u_emit < use_mat["emit"]:
            return True, use_p + nd * E, nd, np.zeros(3), albedo.copy()
        l_col = np.zeros(3)
        for light in ok_lights:
            if light.kind == "point":
                l = np.asarray(light.pos, np.float64) - use_p
            else:
                l = -norm(np.asarray(light.dir, np.float64))
            ln = norm(l)
            diff = max(float(ln @ use_n), 0.0)
            spec = max(float(d @ reflect3(ln, use_n)), 0.0) ** 32 \
                * (1.0 - use_mat["rough"])
            o_col = albedo * (1.0 - use_mat["metal"])
            l_col = l_col + (o_col * diff * np.asarray(light.color, np.float64)
                             + spec) * float(light.pwr)
        return True, use_p + nd * E, nd, pwr * (0.5 + albedo), pwr * l_col

    def radiance(self, x, y, samples):
        acc = np.zeros(3)
        for _ in range(samples):
            acc += self.trace_pixel(x, y)
        return acc / samples
