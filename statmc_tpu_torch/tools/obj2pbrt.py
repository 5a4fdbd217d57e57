# Copied from statmc_tpu/tools/obj2pbrt.py (numpy host code; the usage line and
# the reference's path rewritten, behaviour unchanged).
"""obj2pbrt: Wavefront OBJ -> pbrt scene fragment converter.

Re-derivation of the reference tool (the reference's src/tools/
obj2pbrt.cpp, itself built on tinyobjloader): parses v/vn/vt/f records
with fan triangulation of polygons, splits shapes per usemtl group,
reads the companion .mtl for diffuse/specular/dissolve/map_Kd, and
emits NamedMaterial + trianglemesh blocks with per-face-consistent
index buffers.

Usage: python -m statmc_tpu_torch.tools.obj2pbrt scene.obj out.pbrt
"""
from __future__ import annotations

import os
import sys


def _parse_mtl(path):
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = {"Kd": (0.5, 0.5, 0.5), "Ks": (0.0, 0.0, 0.0),
                       "d": 1.0, "map_Kd": None, "Ns": 0.0}
                mats[tok[1]] = cur
            elif cur is None:
                continue
            elif tok[0] == "Kd":
                cur["Kd"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "Ks":
                cur["Ks"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "d":
                cur["d"] = float(tok[1])
            elif tok[0] == "Tr":
                cur["d"] = 1.0 - float(tok[1])
            elif tok[0] == "Ns":
                cur["Ns"] = float(tok[1])
            elif tok[0] == "map_Kd":
                cur["map_Kd"] = tok[-1]
    return mats


def _vidx(tok, nv, nt, nn):
    """OBJ f-token 'v/vt/vn' with 1-based or negative indices."""
    parts = tok.split("/")

    def fix(s, n):
        if not s:
            return -1
        i = int(s)
        return (i - 1) if i > 0 else (n + i)

    v = fix(parts[0], nv)
    vt = fix(parts[1], nt) if len(parts) > 1 else -1
    vn = fix(parts[2], nn) if len(parts) > 2 else -1
    return v, vt, vn


def convert(obj_path: str, out_path: str) -> int:
    """Returns the number of shapes written."""
    vs, vts, vns = [], [], []
    groups = {}  # material name -> list of (v,vt,vn) triples per tri
    cur_mat = ""
    mtl = {}
    with open(obj_path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                vs.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "vt":
                vts.append(tuple(float(x) for x in tok[1:3]))
            elif tok[0] == "vn":
                vns.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "mtllib":
                mtl.update(_parse_mtl(os.path.join(
                    os.path.dirname(os.path.abspath(obj_path)), tok[1])))
            elif tok[0] == "usemtl":
                cur_mat = tok[1]
            elif tok[0] == "f":
                idx = [_vidx(t, len(vs), len(vts), len(vns))
                       for t in tok[1:]]
                tris = groups.setdefault(cur_mat, [])
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))

    n_shapes = 0
    with open(out_path, "w") as out:
        out.write(f"# generated by obj2pbrt from {obj_path}\n")
        for mat_name, tris in groups.items():
            m = mtl.get(mat_name)
            if m is not None:
                kd = m["Kd"]
                ks = m["Ks"]
                if m["d"] < 1.0:
                    out.write(
                        f'MakeNamedMaterial "{mat_name or "default"}" '
                        '"string type" "translucent" '
                        f'"rgb Kd" [{kd[0]} {kd[1]} {kd[2]}]\n')
                elif max(ks) > 0:
                    rough = max(1e-3, 1.0 / max(m["Ns"], 1.0))
                    out.write(
                        f'MakeNamedMaterial "{mat_name or "default"}" '
                        '"string type" "plastic" '
                        f'"rgb Kd" [{kd[0]} {kd[1]} {kd[2]}] '
                        f'"rgb Ks" [{ks[0]} {ks[1]} {ks[2]}] '
                        f'"float roughness" [{rough}]\n')
                else:
                    out.write(
                        f'MakeNamedMaterial "{mat_name or "default"}" '
                        '"string type" "matte" '
                        f'"rgb Kd" [{kd[0]} {kd[1]} {kd[2]}]\n')
                out.write(f'NamedMaterial "{mat_name or "default"}"\n')

            # Re-index: unique (v, vt, vn) triples per group.
            remap = {}
            P, UV, N, I = [], [], [], []
            has_uv = all(t[1] >= 0 for tri in tris for t in tri)
            has_n = all(t[2] >= 0 for tri in tris for t in tri)
            for tri in tris:
                for t in tri:
                    if t not in remap:
                        remap[t] = len(remap)
                        P.append(vs[t[0]])
                        if has_uv:
                            UV.append(vts[t[1]])
                        if has_n:
                            N.append(vns[t[2]])
                    I.append(remap[t])
            out.write('AttributeBegin\n')
            out.write('Shape "trianglemesh"\n')
            out.write('  "integer indices" [' +
                      " ".join(map(str, I)) + "]\n")
            out.write('  "point P" [' + " ".join(
                f"{p[0]} {p[1]} {p[2]}" for p in P) + "]\n")
            if has_n:
                out.write('  "normal N" [' + " ".join(
                    f"{n[0]} {n[1]} {n[2]}" for n in N) + "]\n")
            if has_uv:
                out.write('  "float uv" [' + " ".join(
                    f"{u[0]} {u[1]}" for u in UV) + "]\n")
            out.write('AttributeEnd\n')
            n_shapes += 1
    return n_shapes


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: obj2pbrt <OBJ filename> <pbrt filename>",
              file=sys.stderr)
        return 1
    n = convert(argv[0], argv[1])
    print(f"wrote {n} shapes to {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
