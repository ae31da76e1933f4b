"""Self-contained interactive 3-D viewer export (WebGL, no dependencies).

A copy of ``objective_slam_tpu.utils.html_viewer`` (numpy only; the port
cannot import the JAX package). The reference opens a PCLVisualizer window
with per-cloud colors and a normals overlay (alignment.cpp:337-396); a
machine without a display gets one HTML file instead, plain WebGL1 with no
external scripts, so it opens offline:

  - orbit (drag), pan (right-drag or shift-drag), zoom (wheel);
  - one visibility checkbox per cloud (scene, each aligned model);
  - a normals overlay drawing every k-th normal at 2 % of the scene extent
    (the PCLVisualizer overlay, alignment.cpp:354-360);
  - a point-size slider.

Point data is embedded as base64 little-endian float32, 12 bytes a point
before base64.
"""

from __future__ import annotations

import base64
import json

import numpy as np

_PALETTE = [(255, 80, 80), (80, 255, 80), (90, 120, 255),
            (80, 255, 255), (255, 80, 255), (255, 255, 80)]


def default_color(i: int) -> tuple[int, int, int]:
    """The cycling 6-color palette (alignment.cpp:35-42, 362)."""
    return _PALETTE[i % len(_PALETTE)]


def write_html_viewer(path, clouds, title="objective_slam_tpu viewer",
                      normal_stride: int = 10) -> None:
    """Write an interactive viewer for `clouds` to `path`.

    clouds: iterable of dicts with
      points  (n, 3) array (required)
      normals (n, 3) array or None
      color   (r, g, b) 0-255 (default: light grey for the first cloud,
              palette colors after, as in the CLI's PLY export)
      name    checkbox label (default "cloud<i>")
    """
    metas = []
    blobs = []
    for i, c in enumerate(clouds):
        pts = np.ascontiguousarray(np.asarray(c["points"], np.float32))
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"cloud {i}: points must be (n, 3)")
        nrm = c.get("normals")
        color = c.get("color")
        if color is None:
            color = (230, 230, 230) if i == 0 else default_color(i - 1)
        meta = {"name": str(c.get("name", f"cloud{i}")),
                "color": [int(x) for x in color],
                "n": int(pts.shape[0]),
                "points": len(blobs)}
        blobs.append(base64.b64encode(pts.tobytes()).decode())
        if nrm is not None:
            nrm = np.ascontiguousarray(np.asarray(nrm, np.float32))
            if nrm.shape != pts.shape:
                raise ValueError(f"cloud {i}: normals shape != points")
            meta["normals"] = len(blobs)
            meta["normal_stride"] = int(normal_stride)
            blobs.append(base64.b64encode(
                np.ascontiguousarray(nrm[::normal_stride]).tobytes())
                .decode())
        metas.append(meta)

    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__META__", json.dumps(metas))
            .replace("__BLOBS__", json.dumps(blobs)))
    with open(path, "w") as f:
        f.write(html)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101014;
   font:13px sans-serif;color:#ddd}
 #c{width:100%;height:100%;display:block}
 #ui{position:absolute;top:10px;left:10px;background:rgba(20,20,28,.85);
   padding:10px 14px;border-radius:8px;user-select:none;max-width:260px}
 #ui label{display:block;margin:2px 0;cursor:pointer}
 #ui .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
   margin-right:6px}
 #stats{margin-top:6px;color:#9a9aa5;font-size:11px}
 input[type=range]{width:120px;vertical-align:middle}
</style></head><body>
<canvas id="c"></canvas>
<div id="ui">
 <b>__TITLE__</b>
 <div id="clouds"></div>
 <label><input type="checkbox" id="nrm"> normals</label>
 <label>point size <input type="range" id="psz" min="1" max="6"
   step="0.5" value="2"></label>
 <div id="stats"></div>
 <div id="stats2">drag orbit &middot; shift/right-drag pan &middot;
   wheel zoom</div>
</div>
<script>
"use strict";
const META = __META__;
const BLOBS = __BLOBS__;
function f32(i){
  const s = atob(BLOBS[i]), a = new Uint8Array(s.length);
  for (let j = 0; j < s.length; j++) a[j] = s.charCodeAt(j);
  return new Float32Array(a.buffer);
}
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:true});
if (!gl) document.body.textContent = "WebGL unavailable";

function mk(type, src){
  const sh = gl.createShader(type); gl.shaderSource(sh, src);
  gl.compileShader(sh);
  if (!gl.getShaderParameter(sh, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(sh);
  return sh;
}
const prog = gl.createProgram();
gl.attachShader(prog, mk(gl.VERTEX_SHADER,
 "attribute vec3 p;uniform mat4 mvp;uniform float ps;"+
 "void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;}"));
gl.attachShader(prog, mk(gl.FRAGMENT_SHADER,
 "precision mediump float;uniform vec3 col;"+
 "void main(){gl_FragColor=vec4(col,1.);}"));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS))
  throw gl.getProgramInfoLog(prog);
gl.useProgram(prog);
const locP = gl.getAttribLocation(prog, "p");
const locMVP = gl.getUniformLocation(prog, "mvp");
const locPS = gl.getUniformLocation(prog, "ps");
const locCol = gl.getUniformLocation(prog, "col");
gl.enableVertexAttribArray(locP);
gl.enable(gl.DEPTH_TEST);

// Bounding box over all clouds -> camera target/extent.
let lo = [1e30,1e30,1e30], hi = [-1e30,-1e30,-1e30], total = 0;
const clouds = META.map(m => {
  const pts = f32(m.points); total += m.n;
  for (let i = 0; i < pts.length; i += 3)
    for (let k = 0; k < 3; k++){
      if (pts[i+k] < lo[k]) lo[k] = pts[i+k];
      if (pts[i+k] > hi[k]) hi[k] = pts[i+k];
    }
  const buf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER, pts, gl.STATIC_DRAW);
  const c = {meta:m, buf:buf, n:m.n, pts:pts, visible:true, nbuf:null,
             nn:0};
  return c;
});
const ctr = [(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const extent = Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2]) || 1;
// Normal overlays: every stride-th point, 2% of extent (built lazily).
function buildNormals(c){
  if (c.nbuf || c.meta.normals === undefined) return;
  const nr = f32(c.meta.normals), st = c.meta.normal_stride;
  const ln = 0.02*extent, m = nr.length/3;
  const seg = new Float32Array(m*6);
  for (let i = 0; i < m; i++){
    const pi = 3*i*st;
    for (let k = 0; k < 3; k++){
      seg[6*i+k] = c.pts[pi+k];
      seg[6*i+3+k] = c.pts[pi+k] + ln*nr[3*i+k];
    }
  }
  c.nbuf = gl.createBuffer(); c.nn = m*2;
  gl.bindBuffer(gl.ARRAY_BUFFER, c.nbuf);
  gl.bufferData(gl.ARRAY_BUFFER, seg, gl.STATIC_DRAW);
}

// Camera: spherical orbit around a pannable target.
let theta = 0.6, phi = 1.1, dist = 1.8*extent,
    tgt = ctr.slice(), psize = 2, showN = false;
// -- matrix helpers --
function look(eye, at, up){
  let z = [eye[0]-at[0],eye[1]-at[1],eye[2]-at[2]];
  const zl = Math.hypot(z[0],z[1],z[2]); z = z.map(v=>v/zl);
  let x = [up[1]*z[2]-up[2]*z[1], up[2]*z[0]-up[0]*z[2],
           up[0]*z[1]-up[1]*z[0]];
  const xl = Math.hypot(x[0],x[1],x[2]); x = x.map(v=>v/xl);
  const y = [z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2],
             z[0]*x[1]-z[1]*x[0]];
  return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
          -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
          -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
          -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]), 1];
}
function persp(fovy, asp, zn, zf){
  const f = 1/Math.tan(fovy/2), nf = 1/(zn-zf);
  return [f/asp,0,0,0, 0,f,0,0, 0,0,(zf+zn)*nf,-1, 0,0,2*zf*zn*nf,0];
}
function mul(a, b){
  const o = new Array(16);
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++){
    let s = 0;
    for (let k = 0; k < 4; k++) s += a[k*4+j]*b[i*4+k];
    o[i*4+j] = s;
  }
  return o;
}
function draw(){
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth*dpr, h = canvas.clientHeight*dpr;
  if (canvas.width !== w || canvas.height !== h){
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.063, 0.063, 0.078, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const eye = [tgt[0]+dist*Math.sin(phi)*Math.cos(theta),
               tgt[1]+dist*Math.cos(phi),
               tgt[2]+dist*Math.sin(phi)*Math.sin(theta)];
  const mvp = mul(persp(0.8, w/h, 0.002*extent, 40*extent),
                  look(eye, tgt, [0,1,0]));
  gl.uniformMatrix4fv(locMVP, false, new Float32Array(mvp));
  gl.uniform1f(locPS, psize*(window.devicePixelRatio||1));
  for (const c of clouds){
    if (!c.visible) continue;
    const col = c.meta.color;
    gl.uniform3f(locCol, col[0]/255, col[1]/255, col[2]/255);
    gl.bindBuffer(gl.ARRAY_BUFFER, c.buf);
    gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.POINTS, 0, c.n);
    if (showN && c.meta.normals !== undefined){
      buildNormals(c);
      gl.uniform3f(locCol, 0.55, 0.55, 0.6);
      gl.bindBuffer(gl.ARRAY_BUFFER, c.nbuf);
      gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
      gl.drawArrays(gl.LINES, 0, c.nn);
    }
  }
}
let need = true;
function loop(){ if (need){ draw(); need = false; }
  requestAnimationFrame(loop); }
requestAnimationFrame(loop);
window.addEventListener("resize", () => need = true);

// Interaction.
let drag = null;
canvas.addEventListener("contextmenu", e => e.preventDefault());
canvas.addEventListener("mousedown", e => {
  drag = {x:e.clientX, y:e.clientY, pan:(e.button===2||e.shiftKey)};
});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX-drag.x, dy = e.clientY-drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan){
    const s = dist*0.0012;
    // Pan in the camera's screen plane.
    const rx = [Math.sin(theta-Math.PI/2), 0, Math.cos(theta-Math.PI/2)];
    const fw = [Math.sin(phi)*Math.cos(theta), Math.cos(phi),
                Math.sin(phi)*Math.sin(theta)];
    const up = [rx[1]*fw[2]-rx[2]*fw[1], rx[2]*fw[0]-rx[0]*fw[2],
                rx[0]*fw[1]-rx[1]*fw[0]];
    for (let k = 0; k < 3; k++)
      tgt[k] += -dx*s*rx[k] + dy*s*up[k];
  } else {
    theta += dx*0.008;
    phi = Math.min(3.1, Math.max(0.04, phi - dy*0.008));
  }
  need = true;
});
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.pow(1.1, e.deltaY > 0 ? 1 : -1);
  need = true;
}, {passive:false});

// UI.
const cl = document.getElementById("clouds");
clouds.forEach((c, i) => {
  const lab = document.createElement("label");
  const cb = document.createElement("input");
  cb.type = "checkbox"; cb.checked = true;
  cb.addEventListener("change", () => { c.visible = cb.checked;
                                        need = true; });
  const sw = document.createElement("span");
  sw.className = "sw";
  sw.style.background = `rgb(${c.meta.color.join(",")})`;
  lab.appendChild(cb); lab.appendChild(sw);
  lab.appendChild(document.createTextNode(
    ` ${c.meta.name} (${c.n.toLocaleString()})`));
  cl.appendChild(lab);
});
document.getElementById("nrm").addEventListener("change", e => {
  showN = e.target.checked; need = true; });
document.getElementById("psz").addEventListener("input", e => {
  psize = parseFloat(e.target.value); need = true; });
document.getElementById("stats").textContent =
  `${clouds.length} clouds, ${total.toLocaleString()} points`;
window.__viewer_ready = {clouds: clouds.length, points: total};
</script></body></html>
"""
