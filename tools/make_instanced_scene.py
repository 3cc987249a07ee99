"""Write a seeded instanced test scene: ``n_inst`` instances of one
displaced-grid OBJ (2 * grid^2 triangles each) on a floor under an area
light, as ``instanced.xml`` + ``bump.obj`` in the output directory.

    python tools/make_instanced_scene.py <out_dir> [n_inst] [grid] [res]

Flattening it takes the device-instancing path (flatten/instanced.py).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def make(out_dir, n_inst=50, grid=8, res=64):
    """Write the scene; returns the XML path."""
    tmp_path = Path(out_dir)
    tmp_path.mkdir(parents=True, exist_ok=True)
    g = grid
    xs = np.linspace(-0.5, 0.5, g + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 0.15 * np.sin(6.0 * X) * np.cos(5.0 * Z) + 0.15
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    i = np.arange(g * (g + 1)).reshape(g, g + 1)[:, :g]
    v00 = i.ravel()
    v10 = v00 + (g + 1)
    v01 = v00 + 1
    v11 = v10 + 1
    faces = np.concatenate(
        [np.stack([v00, v11, v10], 1), np.stack([v00, v01, v11], 1)], 0
    )
    obj = tmp_path / "bump.obj"
    with open(obj, "w") as f:
        np.savetxt(f, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, faces + 1, fmt="f %d %d %d")

    rng = np.random.RandomState(3)
    shapes = []
    for k in range(n_inst):
        x = (k % 8 - 3.5) * 1.2
        z = (k // 8 - 3.5) * 1.2
        ang = float(rng.rand() * 360.0)
        shapes.append(f"""
  <shape type="obj">
    <string name="filename" value="bump.obj"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.6, 0.5, 0.4"/></bsdf>
    <transform name="to_world">
      <rotate y="1" angle="{ang:.2f}"/>
      <translate value="{x:.2f}, 0, {z:.2f}"/>
    </transform>
  </shape>""")
    xml = f"""<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective"><float name="fov" value="55"/>
    <transform name="to_world">
      <lookat origin="0, 7, 9" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm"><integer name="width" value="{res}"/>
      <integer name="height" value="{res}"/></film>
  </sensor>
  <shape type="rectangle">
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
    <transform name="to_world">
      <scale value="12"/><rotate x="1" angle="-90"/>
    </transform>
  </shape>
  <shape type="rectangle">
    <bsdf type="diffuse"><rgb name="reflectance" value="0, 0, 0"/></bsdf>
    <emitter type="area"><rgb name="radiance" value="10, 10, 10"/></emitter>
    <transform name="to_world">
      <scale value="2.5"/><rotate x="1" angle="90"/>
      <translate value="0, 8, 0"/>
    </transform>
  </shape>
  {''.join(shapes)}
</scene>"""
    p = tmp_path / "instanced.xml"
    p.write_text(xml)
    return p


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[2:]]
    print(make(sys.argv[1], *args))
