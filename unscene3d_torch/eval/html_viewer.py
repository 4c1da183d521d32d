"""Self-contained interactive HTML point-cloud viewer (the port's own copy
of unscene3d_tpu/eval/html_viewer.py).

The reference saves browsable pyviz3d scenes for qualitative inspection
(reference trainer/trainer.py:197-357,
pseudo_masks/unscene3d_pseudo_main.py:601-644). This module writes ONE
.html file per scene with the point data embedded as base64 typed arrays
and a dependency-free WebGL1 renderer: orbit / pan / zoom, switchable color
layers (RGB / segments / instances / PCA / ...), a point-size slider. It
opens in any browser with no server and no network access, and its bytes
equal the JAX module's for the same inputs.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 body{{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}}
 #ui{{position:fixed;top:8px;left:8px;background:#222a;padding:8px 10px;
     border-radius:6px;z-index:2}}
 #ui select,#ui input{{margin-left:6px;vertical-align:middle}}
 canvas{{display:block;width:100vw;height:100vh}}
</style></head><body>
<div id="ui"><b>{title}</b>
 <label>layer<select id="layer">{options}</select></label>
 <label>size<input id="psize" type="range" min="1" max="8" step="0.5" value="2.5"></label>
 <span id="n"></span></div>
<canvas id="c"></canvas>
<script>
"use strict";
const POS_B64 = "{pos_b64}";
const LAYERS = {layers_json};
function decode(b64, T) {{
  const s = atob(b64); const u = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) u[i] = s.charCodeAt(i);
  return new T(u.buffer);
}}
const pos = decode(POS_B64, Float32Array);
const N = pos.length / 3;
document.getElementById("n").textContent = N.toLocaleString() + " pts";
const colors = {{}};
for (const k in LAYERS) colors[k] = decode(LAYERS[k], Uint8Array);

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
const vs = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
uniform float ps; varying vec3 vc;
void main(){{ gl_Position = mvp * vec4(p,1.0); gl_PointSize = ps; vc = col; }}`;
const fs = `precision mediump float; varying vec3 vc;
void main(){{ gl_FragColor = vec4(vc, 1.0); }}`;
function sh(t, src) {{ const s = gl.createShader(t); gl.shaderSource(s, src);
  gl.compileShader(s); return s; }}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
const posBuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, posBuf);
gl.bufferData(gl.ARRAY_BUFFER, pos, gl.STATIC_DRAW);
const aP = gl.getAttribLocation(prog, "p");
gl.enableVertexAttribArray(aP);
gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 0, 0);
const colBuf = gl.createBuffer();
const aC = gl.getAttribLocation(prog, "col");
function setLayer(name) {{
  gl.bindBuffer(gl.ARRAY_BUFFER, colBuf);
  gl.bufferData(gl.ARRAY_BUFFER, colors[name], gl.STATIC_DRAW);
  gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC, 3, gl.UNSIGNED_BYTE, true, 0, 0);
}}
const sel = document.getElementById("layer");
sel.onchange = () => {{ setLayer(sel.value); draw(); }};
setLayer(sel.value);

// center / radius
let cx=0, cy=0, cz=0;
for (let i = 0; i < N; i++) {{ cx+=pos[3*i]; cy+=pos[3*i+1]; cz+=pos[3*i+2]; }}
cx/=N; cy/=N; cz/=N;
let rad = 0;
for (let i = 0; i < N; i++) {{
  const dx=pos[3*i]-cx, dy=pos[3*i+1]-cy, dz=pos[3*i+2]-cz;
  rad = Math.max(rad, dx*dx+dy*dy+dz*dz); }}
rad = Math.sqrt(rad) || 1;
let theta = 0.8, phi = 1.0, dist = rad * 2.4, panX = 0, panY = 0;

function mat() {{
  const w = canvas.width, h = canvas.height, asp = w / h;
  const f = 1.5, near = rad * 0.01, far = rad * 40;
  const eye = [
    cx + dist * Math.sin(phi) * Math.cos(theta),
    cy + dist * Math.sin(phi) * Math.sin(theta),
    cz + dist * Math.cos(phi)];
  const tgt = [cx, cy, cz];
  let zx=eye[0]-tgt[0], zy=eye[1]-tgt[1], zz=eye[2]-tgt[2];
  let zl=Math.hypot(zx,zy,zz); zx/=zl; zy/=zl; zz/=zl;
  let xx=-zy, xy=zx, xz=0; let xl=Math.hypot(xx,xy,xz)||1; xx/=xl; xy/=xl;
  const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
  const ex=eye[0]+(xx*panX+yx*panY), ey=eye[1]+(xy*panX+yy*panY),
        ez=eye[2]+(xz*panX+yz*panY);
  const tx=-(xx*ex+xy*ey+xz*ez), ty=-(yx*ex+yy*ey+yz*ez),
        tz=-(zx*ex+zy*ey+zz*ez);
  const view = [xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0, tx,ty,tz,1];
  const pm = [f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
              0,0,2*far*near/(near-far),0];
  const out = new Float32Array(16);
  for (let r = 0; r < 4; r++) for (let c = 0; c < 4; c++) {{
    let s = 0; for (let k = 0; k < 4; k++) s += view[r*4+k]*pm[k*4+c];
    out[r*4+c] = s; }}
  return out;
}}
const uM = gl.getUniformLocation(prog, "mvp");
const uS = gl.getUniformLocation(prog, "ps");
function draw() {{
  canvas.width = innerWidth * devicePixelRatio;
  canvas.height = innerHeight * devicePixelRatio;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.enable(gl.DEPTH_TEST);
  gl.clearColor(0.07, 0.07, 0.07, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uM, false, mat());
  gl.uniform1f(uS, parseFloat(document.getElementById("psize").value)
                   * devicePixelRatio);
  gl.drawArrays(gl.POINTS, 0, N);
}}
let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY, e.button];
onmouseup = () => drag = null;
onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2] === 2 || e.shiftKey) {{
    panX -= dx * dist * 0.0015; panY += dy * dist * 0.0015;
  }} else {{
    theta -= dx * 0.008;
    phi = Math.min(Math.PI - 0.05, Math.max(0.05, phi - dy * 0.008));
  }}
  drag = [e.clientX, e.clientY, drag[2]]; draw();
}};
canvas.oncontextmenu = e => e.preventDefault();
onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); draw(); }};
document.getElementById("psize").oninput = draw;
onresize = draw;
draw();
</script></body></html>
"""


def save_scene_html(out_path: str, coords: np.ndarray,
                    layers: dict[str, np.ndarray],
                    max_points: int = 400_000, seed: int = 0) -> str:
    """Write a standalone interactive viewer. layers: name -> (N, 3) uint8
    colors (first entry is the default layer). Subsamples uniformly past
    max_points to bound the file size (~15MB at the cap)."""
    coords = np.asarray(coords, np.float32)
    n = len(coords)
    if n > max_points:
        idx = np.random.RandomState(seed).choice(n, max_points, replace=False)
        idx.sort()
        coords = coords[idx]
        layers = {k: np.asarray(v)[idx] for k, v in layers.items()}
    pos_b64 = base64.b64encode(np.ascontiguousarray(coords).tobytes()).decode()
    enc = {}
    for k, v in layers.items():
        v = np.asarray(v)
        if v.shape != (len(coords), 3):
            raise ValueError(f"layer {k!r}: shape {v.shape}, expected "
                             f"({len(coords)}, 3)")
        enc[k] = base64.b64encode(
            np.ascontiguousarray(v.astype(np.uint8)).tobytes()).decode()
    options = "".join(f'<option value="{k}">{k}</option>' for k in enc)
    html = _TEMPLATE.format(
        title=os.path.splitext(os.path.basename(out_path))[0],
        options=options, pos_b64=pos_b64, layers_json=json.dumps(enc))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
