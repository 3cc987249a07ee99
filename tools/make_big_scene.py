"""Generate a large displaced-grid OBJ + scene XML (seeded, deterministic).

    python tools/make_big_scene.py data/generated/big_env 450   # ~405k tris
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

XML = """<scene version="3.0.0">
    <integrator type="path"><integer name="max_depth" value="4" /></integrator>
    <sensor type="perspective">
        <float name="fov" value="50" />
        <transform name="to_world">
            <lookat origin="1.8, 1.4, 2.4" target="0, 0.25, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="{w}" />
            <integer name="height" value="{h}" />
        </film>
    </sensor>
    <shape type="obj">
        <string name="filename" value="{obj}" />
        <bsdf type="roughconductor">
            <string name="material" value="Cu" />
            <float name="alpha" value="0.15" />
        </bsdf>
    </shape>
    <shape type="rectangle">
        <bsdf type="diffuse"><rgb name="reflectance" value="0.6,0.6,0.6"/></bsdf>
        <transform name="to_world">
            <rotate x="1" angle="-90"/>
            <scale x="6" y="1" z="6"/>
            <translate value="0, -0.02, 0"/>
        </transform>
    </shape>
    <emitter type="envmap">
        <string name="filename" value="{env}" />
        <float name="scale" value="2.5" />
    </emitter>
</scene>
"""


def make(out_dir: str, grid: int = 450, w: int = 320, h: int = 180) -> str:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    g = grid
    xs = np.linspace(-1.5, 1.5, g + 1)
    zs = np.linspace(-1.5, 1.5, g + 1)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    # deterministic rolling-hills displacement with high-frequency detail
    Y = (
        0.18 * np.sin(2.3 * X) * np.cos(1.7 * Z)
        + 0.08 * np.sin(9.0 * X + 3.0 * Z)
        + 0.03 * np.cos(23.0 * X) * np.sin(19.0 * Z)
        + 0.3
    )
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    i = np.arange(g * (g + 1)).reshape(g, g + 1)[:, :g]
    v00 = i.ravel()
    v10 = v00 + (g + 1)
    v01 = v00 + 1
    v11 = v10 + 1
    # winding chosen so face normals point +Y (v10 is +X, v01 is +Z)
    faces = np.concatenate(
        [np.stack([v00, v11, v10], 1), np.stack([v00, v01, v11], 1)], 0
    )
    obj = out / f"hills_{g}.obj"
    with open(obj, "w") as f:
        f.write("# generated displaced grid\n")
        np.savetxt(f, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, faces + 1, fmt="f %d %d %d")
    xml = out / "big_env.xml"
    env = Path(__file__).resolve().parent.parent / "data" / "env" / "sky.exr"
    xml.write_text(XML.format(obj=obj.name, env=str(env), w=w, h=h))
    print(f"{obj} ({faces.shape[0]} tris), {xml}")
    return str(xml)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else str(
        Path(__file__).resolve().parent.parent / "data" / "generated"
        / "big_env"
    )
    grid = int(sys.argv[2]) if len(sys.argv) > 2 else 450
    make(out, grid)
