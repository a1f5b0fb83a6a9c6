"""Live browser viewer: frame views, compute stats, live-imaging controls.

The interactive counterpart of the reference's raylib/Vulkan UI (ui.c):
frame views with dB-range/gamma controls, the ComputeBarGraph/ComputeStats
panels, and LiveImagingControls — served as a small zero-dependency HTTP
app (stdlib ``http.server``) that any browser can attach to while the
beamformer streams.  Rendering reuses the display transfer function of
render_3d.frag.glsl:61-70 via ops/display.py.

Usage::

    from ogl_beamforming_tpu_torch.viewer_web import LiveView
    view = LiveView(beamformer).start()       # http://localhost:8765
    ...
    view.stop()
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .params.enums import LiveImagingDirtyFlags
from .viewer import bmode_image


def encode_png_gray(img: np.ndarray) -> bytes:
    """Minimal 8-bit grayscale PNG encoder (no external deps).

    ``img``: 2-D float in [0, 1] or uint8.
    """
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def _crop_resample(img: np.ndarray, region, out: int) -> np.ndarray:
    """Bilinear crop-and-resample of a (rows, cols) [0,1] image to the
    fractional view region (x0, y0, x1, y1); the zoomed frame-view sampling
    of ui.c:1113-1150 (the GL path samples the texture linearly too)."""
    x0, y0, x1, y1 = region
    x0, x1 = sorted((min(max(x0, 0.0), 1.0), min(max(x1, 0.0), 1.0)))
    y0, y1 = sorted((min(max(y0, 0.0), 1.0), min(max(y1, 0.0), 1.0)))
    if x1 - x0 < 1e-3:
        x1 = min(x0 + 1e-3, 1.0)
    if y1 - y0 < 1e-3:
        y1 = min(y0 + 1e-3, 1.0)
    h, w = img.shape
    aspect = ((y1 - y0) * h) / max((x1 - x0) * w, 1e-9)
    if aspect >= 1.0:
        oh, ow = out, max(int(round(out / aspect)), 1)
    else:
        oh, ow = max(int(round(out * aspect)), 1), out
    ys = y0 * (h - 1) + (y1 - y0) * (h - 1) * np.linspace(0, 1, oh)
    xs = x0 * (w - 1) + (x1 - x0) * (w - 1) * np.linspace(0, 1, ow)
    yi = np.clip(ys.astype(np.int32), 0, h - 2)
    xi = np.clip(xs.astype(np.int32), 0, w - 2)
    fy = (ys - yi)[:, None]
    fx = (xs - xi)[None, :]
    a = img[yi][:, xi]
    b = img[yi][:, xi + 1]
    c = img[yi + 1][:, xi]
    d = img[yi + 1][:, xi + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx).astype(np.float32)


_PAGE = """<!doctype html>
<html><head><title>ogl_beamforming_tpu_torch</title>
<style>
 body { background:#111; color:#ddd; font-family:monospace; margin:1em; }
 .row { display:flex; gap:2em; align-items:flex-start; }
 img { image-rendering:pixelated; border:1px solid #444; max-height:80vh; }
 .bar { background:#2a6; height:12px; margin:2px 0; }
 label { display:block; margin-top:.5em; }
 table { border-collapse:collapse; } td { padding:2px 8px; }
</style></head><body>
<h3>ogl_beamforming_tpu_torch &mdash; live view (<a href="/xplane" style="color:#6af">3D x-plane</a> | <a href="/panels" style="color:#6af">panels</a>)</h3>
<div class="row">
 <div>
  <div id="wrap" style="position:relative; display:inline-block;">
   <img id="frame" width="512" draggable="false"
        style="cursor:crosshair; user-select:none;"/>
   <canvas id="overlay" width="512" height="512"
     style="position:absolute; left:0; top:0; pointer-events:none;"></canvas>
  </div>
  <div style="font-size:11px; color:#888;">wheel: zoom &middot; drag: pan
   &middot; dblclick: reset &middot; shift-click: A-scan line</div>
  <label>dB cutoff <input id="db" type="range" min="-100" max="-10"
    value="-60"/> <span id="dbv">-60</span></label>
  <label>gamma <input id="gamma" type="range" min="20" max="300"
    value="100"/> <span id="gv">1.0</span></label>
  <label>plane <select id="plane"><option>xz</option><option>yz</option>
    <option>xy</option></select></label>
 </div>
 <div>
  <h4>compute stats</h4><div id="stats"></div>
  <h4>live controls</h4>
  <label>transmit power <input id="power" type="range" min="0" max="100"
    value="50"/></label>
  <button id="stop">stop imaging</button>
  <h4>A-scan</h4>
  <canvas id="ascan" width="280" height="160"
    style="border:1px solid #444;"></canvas>
  <div id="ascaninfo" style="font-size:11px; color:#888;"></div>
 </div>
</div>
<script>
const db = document.getElementById('db'), gamma = document.getElementById('gamma');
const plane = document.getElementById('plane');
const img = document.getElementById('frame');
const overlay = document.getElementById('overlay');
let view = {x0:0, y0:0, x1:1, y1:1};      // fractional pan/zoom region
let meta = null, ascanFrac = null;
let dragging = false, lastX = 0, lastY = 0, moved = false;
function fw() { return view.x1 - view.x0; }
function fh() { return view.y1 - view.y0; }
function clampView() {
  view.x0 = Math.max(0, Math.min(view.x0, 1 - 1e-3));
  view.y0 = Math.max(0, Math.min(view.y0, 1 - 1e-3));
  view.x1 = Math.max(view.x0 + 1e-3, Math.min(view.x1, 1));
  view.y1 = Math.max(view.y0 + 1e-3, Math.min(view.y1, 1));
}
function drawRulers() {
  const ctx = overlay.getContext('2d');
  overlay.width = img.clientWidth || 512;
  overlay.height = img.clientHeight || 512;
  ctx.clearRect(0, 0, overlay.width, overlay.height);
  if (!meta) return;
  ctx.font = '10px monospace';
  ctx.fillStyle = '#8f8'; ctx.strokeStyle = '#8f8';
  const lat = meta.lat_mm, ax = meta.ax_mm;
  for (let i = 0; i <= 5; i++) {          // lateral ruler (top)
    const f = i / 5, x = f * overlay.width;
    const mm = lat[0] + (view.x0 + f * fw()) * (lat[1] - lat[0]);
    ctx.beginPath(); ctx.moveTo(x, 0); ctx.lineTo(x, 6); ctx.stroke();
    if (i < 5) ctx.fillText(mm.toFixed(1), x + 2, 14);
  }
  for (let i = 0; i <= 5; i++) {          // axial ruler (left)
    const f = i / 5, y = f * overlay.height;
    const mm = ax[0] + (view.y0 + f * fh()) * (ax[1] - ax[0]);
    ctx.beginPath(); ctx.moveTo(0, y); ctx.lineTo(6, y); ctx.stroke();
    if (i < 5) ctx.fillText(mm.toFixed(1), 8, y + 10);
  }
  if (ascanFrac !== null) {               // A-scan line marker
    const fx = (ascanFrac - view.x0) / fw();
    if (fx >= 0 && fx <= 1) {
      ctx.strokeStyle = '#fa4';
      ctx.beginPath();
      ctx.moveTo(fx * overlay.width, 0);
      ctx.lineTo(fx * overlay.width, overlay.height);
      ctx.stroke();
    }
  }
}
async function drawAscan() {
  if (ascanFrac === null) return;
  const a = await (await fetch(`/ascan.json?frac=${ascanFrac}` +
                               `&plane=${plane.value}`)).json();
  const c = document.getElementById('ascan'), ctx = c.getContext('2d');
  ctx.clearRect(0, 0, c.width, c.height);
  ctx.strokeStyle = '#fa4'; ctx.beginPath();
  a.values.forEach((v, i) => {
    const x = i / (a.values.length - 1) * c.width;
    const y = c.height - v * (c.height - 4) - 2;
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
  document.getElementById('ascaninfo').textContent =
    `lateral index ${a.lateral_index}, peak ${a.peak.toExponential(2)}, ` +
    `axial ${a.ax_mm[0].toFixed(1)}..${a.ax_mm[a.ax_mm.length-1].toFixed(1)} mm`;
}
function frameSrc() {
  return `/frame.png?db=${db.value}&gamma=${gamma.value/100}` +
    `&plane=${plane.value}&x0=${view.x0}&y0=${view.y0}` +
    `&x1=${view.x1}&y1=${view.y1}&out=512&t=${Date.now()}`;
}
async function refresh() {
  document.getElementById('dbv').textContent = db.value;
  document.getElementById('gv').textContent = (gamma.value/100).toFixed(2);
  img.src = frameSrc();
  if (!meta) {
    try { meta = await (await fetch(`/frame_meta.json?plane=` +
                                    plane.value)).json(); } catch (e) {}
  }
  drawRulers();
  drawAscan();
  const st = await (await fetch('/stats.json')).json();
  const el = document.getElementById('stats');
  el.innerHTML = '<table>' + st.stages.map(s =>
    `<tr><td>${s.name}</td><td>${(s.avg_ms).toFixed(2)} ms</td>` +
    `<td><div class="bar" style="width:${Math.min(200, s.avg_ms*20)}px">` +
    `</div></td></tr>`).join('') +
    `<tr><td>frame</td><td>${st.frame_ms.toFixed(2)} ms</td></tr>` +
    `<tr><td>rf delta</td><td>${st.rf_delta_ms.toFixed(2)} ms</td></tr>` +
    '</table>';
}
img.addEventListener('wheel', (e) => {
  e.preventDefault();
  const r = img.getBoundingClientRect();
  const fx = view.x0 + (e.clientX - r.left) / r.width * fw();
  const fy = view.y0 + (e.clientY - r.top) / r.height * fh();
  const k = e.deltaY < 0 ? 0.8 : 1.25;
  view.x0 = fx - (fx - view.x0) * k;  view.x1 = fx + (view.x1 - fx) * k;
  view.y0 = fy - (fy - view.y0) * k;  view.y1 = fy + (view.y1 - fy) * k;
  if (fw() > 1 || fh() > 1) view = {x0:0, y0:0, x1:1, y1:1};
  clampView(); img.src = frameSrc(); drawRulers();
});
img.onmousedown = (e) => { dragging = true; moved = false;
                           lastX = e.clientX; lastY = e.clientY;
                           e.preventDefault(); };
window.addEventListener('mousemove', (e) => {
  if (!dragging) return;
  const r = img.getBoundingClientRect();
  const dx = (e.clientX - lastX) / r.width * fw();
  const dy = (e.clientY - lastY) / r.height * fh();
  if (Math.abs(e.clientX - lastX) + Math.abs(e.clientY - lastY) > 2)
    moved = true;
  lastX = e.clientX; lastY = e.clientY;
  view.x0 -= dx; view.x1 -= dx; view.y0 -= dy; view.y1 -= dy;
  clampView(); drawRulers();
});
window.addEventListener('mouseup', (e) => {
  if (!dragging) return;
  dragging = false;
  if (moved) { img.src = frameSrc(); drawRulers(); return; }
  if (e.shiftKey || e.target === img) {
    const r = img.getBoundingClientRect();
    ascanFrac = view.x0 + (e.clientX - r.left) / r.width * fw();
    drawRulers(); drawAscan();
  }
});
img.ondblclick = () => { view = {x0:0, y0:0, x1:1, y1:1};
                         img.src = frameSrc(); drawRulers(); };
plane.onchange = () => { meta = null; refresh(); };
setInterval(refresh, 500); refresh();
document.getElementById('power').onchange = (e) =>
  fetch('/live', {method:'POST', body:JSON.stringify(
    {transmit_power: e.target.value/100})});
document.getElementById('stop').onclick = () =>
  fetch('/live', {method:'POST', body:JSON.stringify({stop: true})});
</script></body></html>
"""


_XPLANE_PAGE = """<!doctype html>
<html><head><title>ogl_beamforming_tpu_torch x-plane</title>
<style>
 body { background:#111; color:#ddd; font-family:monospace; margin:1em; }
 .row { display:flex; gap:1.5em; align-items:flex-start; flex-wrap:wrap; }
 img { image-rendering:pixelated; border:1px solid #444; }
 #view3d { cursor:grab; }
 label { display:block; margin-top:.5em; }
 input[type=number] { width:8em; background:#222; color:#ddd;
   border:1px solid #555; }
</style></head><body>
<h3>3D X-plane view &mdash; drag a plane to slice, drag space to orbit</h3>
<div class="row">
 <div>
  <img id="view3d" width="512" height="512"/>
  <label>dB cutoff <input id="db" type="range" min="-100" max="-10"
    value="-60"/> <span id="dbv">-60</span></label>
  <label>gamma <input id="gamma" type="range" min="20" max="300"
    value="100"/> <span id="gv">1.0</span></label>
 </div>
 <div>
  <div>X plane <img id="sx" width="200"/></div>
  <div>Y plane <img id="sy" width="200"/></div>
  <div>Z plane <img id="sz" width="200"/></div>
  <div>MIP <img id="mip" width="200"/>
   <label><input id="mipon" type="checkbox"/> live</label></div>
  <div>oblique <img id="obl" width="200"/><br/>
   n=(<input id="nx" size="3" value="0"/>,
      <input id="ny" size="3" value="1"/>,
      <input id="nz" size="3" value="1"/>)
   <button onclick="refreshAux()">cut</button></div>
 </div>
 <div>
  <h4>parameters (live)</h4>
  <div id="params"></div>
 </div>
</div>
<script>
let yaw = 0.6, pitch = 0.45, offs = [0, 0, 0];
let dragAxis = null, orbiting = false, lastX = 0, lastY = 0;
const db = document.getElementById('db'), gamma = document.getElementById('gamma');
const v3 = document.getElementById('view3d');
function gval() { return gamma.value / 100; }
function refresh3d() {
  document.getElementById('dbv').textContent = db.value;
  document.getElementById('gv').textContent = gval().toFixed(2);
  v3.src = `/xplane.png?yaw=${yaw}&pitch=${pitch}&ox=${offs[0]}` +
    `&oy=${offs[1]}&oz=${offs[2]}&db=${db.value}&gamma=${gval()}` +
    `&t=${Date.now()}`;
  for (const [i, id] of [[0,'sx'],[1,'sy'],[2,'sz']]) {
    document.getElementById(id).src = `/slice.png?axis=${i}` +
      `&frac=${(offs[i]+1)/2}&db=${db.value}&gamma=${gval()}&t=${Date.now()}`;
  }
  if (document.getElementById('mipon').checked) refreshAux();
}
function refreshAux() {
  document.getElementById('mip').src = `/mip.png?yaw=${yaw}&pitch=${pitch}` +
    `&db=${db.value}&gamma=${gval()}&size=200&t=${Date.now()}`;
  const g = id => document.getElementById(id).value || 0;
  document.getElementById('obl').src = `/oblique.png?nx=${g('nx')}` +
    `&ny=${g('ny')}&nz=${g('nz')}&db=${db.value}&gamma=${gval()}` +
    `&size=200&t=${Date.now()}`;
}
v3.onmousedown = async (e) => {
  const r = v3.getBoundingClientRect();
  lastX = e.clientX; lastY = e.clientY;
  const res = await (await fetch('/pick', {method:'POST',
    body: JSON.stringify({offsets: offs, yaw, pitch,
      x: (e.clientX - r.left) * 512 / r.width,
      y: (e.clientY - r.top) * 512 / r.height})})).json();
  dragAxis = res.axis; orbiting = (dragAxis === null);
  e.preventDefault();
};
window.onmousemove = async (e) => {
  if (dragAxis === null && !orbiting) return;
  const dx = e.clientX - lastX, dy = e.clientY - lastY;
  lastX = e.clientX; lastY = e.clientY;
  if (orbiting) { yaw += dx * 0.01; pitch += dy * 0.01; }
  else {
    const res = await (await fetch('/drag', {method:'POST',
      body: JSON.stringify({offsets: offs, axis: dragAxis, yaw, pitch,
                            dx, dy})})).json();
    offs = res.offsets;
  }
  refresh3d();
};
window.onmouseup = () => { dragAxis = null; orbiting = false; };
async function loadParams() {
  const p = await (await fetch('/params')).json();
  const el = document.getElementById('params');
  el.innerHTML = Object.entries(p).map(([k, v]) =>
    `<label>${k} <input type="number" step="any" value="${v}"
      onchange="setParam('${k}', this.value)"/></label>`).join('');
}
async function setParam(k, v) {
  await fetch('/params', {method:'POST',
                          body: JSON.stringify({[k]: parseFloat(v)})});
}
db.oninput = refresh3d; gamma.oninput = refresh3d;
setInterval(refresh3d, 1000); refresh3d(); loadParams();
</script></body></html>
"""


_PANELS_PAGE = """<!doctype html>
<html><head><title>ogl_beamforming_tpu_torch panels</title>
<style>
 body { background:#111; color:#ddd; font-family:monospace; margin:0;
        height:100vh; display:flex; flex-direction:column; }
 #root { flex:1; display:flex; min-height:0; }
 .split-h { display:flex; flex-direction:row; flex:1; min-width:0; min-height:0; }
 .split-v { display:flex; flex-direction:column; flex:1; min-width:0; min-height:0; }
 .divider-h { width:5px; cursor:col-resize; background:#333; }
 .divider-v { height:5px; cursor:row-resize; background:#333; }
 .leaf { display:flex; flex-direction:column; border:1px solid #333;
         min-width:0; min-height:0; overflow:hidden; }
 .tabbar { background:#1a1a1a; display:flex; gap:2px; padding:2px;
           align-items:center; flex-wrap:wrap; }
 .tab { padding:2px 8px; background:#222; cursor:pointer; }
 .tab.active { background:#2a6; color:#000; }
 .tab .x { margin-left:6px; color:#a33; }
 .body { flex:1; overflow:auto; padding:4px; min-height:0; }
 img { image-rendering:pixelated; max-width:100%; }
 select, button { background:#222; color:#ddd; border:1px solid #555; }
 table { border-collapse:collapse; } td { padding:1px 6px; }
 .bar { background:#2a6; height:10px; }
 label { display:block; }
 input[type=number] { width:7em; background:#222; color:#ddd;
   border:1px solid #555; }
</style></head><body>
<div id="root"></div>
<script>
// Panel tree: split/tab docking — the browser port of the reference UI's
// panel system (ui.c Split/TabGroup panels, beamformer_core.c:1880-2056).
const PANELS = {
  frame:  {title: 'Frame View'},
  stats:  {title: 'Compute Stats'},
  live:   {title: 'Live Controls'},
  params: {title: 'Parameters'},
  xplane: {title: 'X-Plane'},
};
let tree = {type:'split', dir:'h', frac:0.55,
  a:{type:'leaf', tabs:['frame'], active:0},
  b:{type:'split', dir:'v', frac:0.5,
     a:{type:'leaf', tabs:['stats','live'], active:0},
     b:{type:'leaf', tabs:['params','xplane'], active:0}}};

function leafOf(node, target, parent, key) {
  if (node === target) return [parent, key];
  if (node.type === 'split') {
    return leafOf(node.a, target, node, 'a') ||
           leafOf(node.b, target, node, 'b');
  }
  return null;
}
function splitLeaf(leaf, dir) {
  const loc = leafOf(tree, leaf, null, null);
  const fresh = {type:'leaf', tabs:['stats'], active:0};
  const split = {type:'split', dir, frac:0.5, a:{...leaf}, b:fresh};
  if (!loc || !loc[0]) tree = split; else loc[0][loc[1]] = split;
  render();
}
function closeTab(leaf, i) {
  leaf.tabs.splice(i, 1);
  leaf.active = Math.max(0, leaf.active - 1);
  if (!leaf.tabs.length) {
    const loc = leafOf(tree, leaf, null, null);
    if (loc && loc[0]) {
      const parent = loc[0];
      const keep = loc[1] === 'a' ? parent.b : parent.a;
      const ploc = leafOf(tree, parent, null, null);
      if (!ploc || !ploc[0]) tree = keep; else ploc[0][ploc[1]] = keep;
    } else leaf.tabs = ['stats'];
  }
  render();
}
function build(node, el) {
  if (node.type === 'split') {
    el.className = node.dir === 'h' ? 'split-h' : 'split-v';
    const a = document.createElement('div');
    const d = document.createElement('div');
    const b = document.createElement('div');
    d.className = node.dir === 'h' ? 'divider-h' : 'divider-v';
    a.style.flex = node.frac; b.style.flex = 1 - node.frac;
    d.onmousedown = (e) => {
      const r = el.getBoundingClientRect();
      const move = (ev) => {
        node.frac = Math.min(0.9, Math.max(0.1,
          node.dir === 'h' ? (ev.clientX - r.left) / r.width
                           : (ev.clientY - r.top) / r.height));
        a.style.flex = node.frac; b.style.flex = 1 - node.frac;
      };
      const up = () => { window.removeEventListener('mousemove', move);
                         window.removeEventListener('mouseup', up); };
      window.addEventListener('mousemove', move);
      window.addEventListener('mouseup', up);
      e.preventDefault();
    };
    build(node.a, a); build(node.b, b);
    el.append(a, d, b);
  } else {
    el.className = 'leaf';
    const bar = document.createElement('div');
    bar.className = 'tabbar';
    node.tabs.forEach((t, i) => {
      const tab = document.createElement('span');
      tab.className = 'tab' + (i === node.active ? ' active' : '');
      tab.textContent = PANELS[t].title;
      tab.onclick = () => { node.active = i; render(); };
      const x = document.createElement('span');
      x.className = 'x'; x.textContent = 'x';
      x.onclick = (e) => { e.stopPropagation(); closeTab(node, i); };
      tab.append(x); bar.append(tab);
    });
    const add = document.createElement('select');
    add.innerHTML = '<option>+</option>' + Object.entries(PANELS).map(
      ([k, v]) => `<option value="${k}">${v.title}</option>`).join('');
    add.onchange = () => { if (add.value !== '+') {
      node.tabs.push(add.value); node.active = node.tabs.length - 1;
      render(); } };
    const sh = document.createElement('button');
    sh.textContent = '|'; sh.title = 'split horizontally';
    sh.onclick = () => splitLeaf(node, 'h');
    const sv = document.createElement('button');
    sv.textContent = '—'; sv.title = 'split vertically';
    sv.onclick = () => splitLeaf(node, 'v');
    bar.append(add, sh, sv);
    const body = document.createElement('div');
    body.className = 'body';
    body.dataset.panel = node.tabs[node.active];
    el.append(bar, body);
  }
}
function render() {
  const root = document.getElementById('root');
  root.innerHTML = '';
  const el = document.createElement('div');
  el.style.cssText = 'flex:1;display:flex;min-height:0';
  build(tree, el);
  root.append(el);
  refreshAll();
}
async function refreshAll() {
  for (const body of document.querySelectorAll('.body')) {
    const kind = body.dataset.panel;
    if (kind === 'frame') {
      body.innerHTML = `<img src="/frame.png?t=${Date.now()}"/>`;
    } else if (kind === 'xplane') {
      body.innerHTML =
        `<img src="/xplane.png?size=256&t=${Date.now()}"/>` +
        `<div><a href="/xplane" style="color:#6af">open interactive</a></div>`;
    } else if (kind === 'stats') {
      const st = await (await fetch('/stats.json')).json();
      body.innerHTML = '<table>' + st.stages.map(s =>
        `<tr><td>${s.name}</td><td>${s.avg_ms.toFixed(2)} ms</td>` +
        `<td><div class="bar" style="width:${Math.min(150, s.avg_ms*15)}px">` +
        `</div></td></tr>`).join('') +
        `<tr><td>frame</td><td>${st.frame_ms.toFixed(2)} ms</td></tr></table>`;
    } else if (kind === 'live') {
      body.innerHTML =
        `<label>transmit power <input type="range" min="0" max="100"
          onchange="fetch('/live',{method:'POST',body:JSON.stringify(
            {transmit_power:this.value/100})})"/></label>
         <button onclick="fetch('/live',{method:'POST',
           body:JSON.stringify({stop:true})})">stop imaging</button>`;
    } else if (kind === 'params') {
      const p = await (await fetch('/params')).json();
      body.innerHTML = Object.entries(p).map(([k, v]) =>
        `<label>${k} <input type="number" step="any" value="${v}"
          onchange="fetch('/params',{method:'POST',body:JSON.stringify(
            {'${k}':parseFloat(this.value)})})"/></label>`).join('');
    }
  }
}
render();
setInterval(refreshAll, 1500);
</script></body></html>
"""


class LiveView:
    """HTTP live view over a :class:`..pipeline.executor.Beamformer`."""

    def __init__(self, beamformer, host: str = "127.0.0.1", port: int = 8765):
        self.beamformer = beamformer
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- data accessors (also used by tests) ----------------------------

    def frame_png(self, db_cutoff=-60.0, gamma=1.0, plane="xz",
                  x0=0.0, y0=0.0, x1=1.0, y1=1.0, out=0) -> bytes:
        """Frame view with pan/zoom: renders the fractional sub-region
        [x0,x1) x [y0,y1) (x = lateral, y = axial) resampled to ``out``
        pixels on the long side (ui.c:1113-1150 view-region zoom)."""
        frames = self.beamformer.get_last_frames(1)
        if not frames:
            return encode_png_gray(np.zeros((16, 16), np.uint8))
        img = bmode_image(frames[-1], plane=plane, db_cutoff=db_cutoff,
                          gamma=gamma)
        region = (float(x0), float(y0), float(x1), float(y1))
        if region != (0.0, 0.0, 1.0, 1.0) or out:
            img = _crop_resample(img, region, int(out) or 512)
        return encode_png_gray(img)

    def frame_meta_json(self, plane="xz") -> dict:
        """World-coordinate extents of the frame view's axes, for rulers.

        Maps the voxel-cube corners through das_voxel_transform and reports
        the dominant world component along each image axis (in mm)."""
        p = self.beamformer._block(0).parameters
        vt = np.asarray(p.das_voxel_transform, np.float64)
        nx, ny, nz = (int(v) for v in p.output_points[:3])

        def world(px, py, pz):
            return (vt @ np.array([px, py, pz, 1.0]))[:3]

        w00 = world(0, 0, 0)
        if nz > 1 and plane == "xz":       # 3D: x lateral, z axial
            wlat, wax = world(1, 0, 0), world(0, 0, 1)
            n_lat, n_ax = nx, nz
        elif nz > 1 and plane == "yz":
            wlat, wax = world(0, 1, 0), world(0, 0, 1)
            n_lat, n_ax = ny, nz
        else:                              # 2D grids: x lateral, y axial
            wlat, wax = world(1, 0, 0), world(0, 1, 0)
            n_lat, n_ax = nx, ny
        il = int(np.argmax(np.abs(wlat - w00)))
        ia = int(np.argmax(np.abs(wax - w00)))
        return {"lat_mm": [w00[il] * 1e3, wlat[il] * 1e3],
                "ax_mm": [w00[ia] * 1e3, wax[ia] * 1e3],
                "shape": [n_ax, n_lat]}

    def ascan_json(self, frac=0.5, plane="xz") -> dict:
        """Axial magnitude line at lateral fraction ``frac`` — the A-scan
        overlay of the reference's 3D view (render_3d.frag.glsl:98-109),
        served for the 2D frame views."""
        frames = self.beamformer.get_last_frames(1)
        if not frames:
            return {"values": [], "ax_mm": []}
        from .utils.device import to_host
        data = to_host(frames[-1].data)
        if data.ndim == 3:
            data = data[:, :, 0] if data.shape[2] == 1 \
                else data[:, data.shape[1] // 2, :]
        ix = int(round(float(frac) * (data.shape[0] - 1)))
        vals = np.abs(data[np.clip(ix, 0, data.shape[0] - 1)])
        meta = self.frame_meta_json(plane)
        ax = np.linspace(meta["ax_mm"][0], meta["ax_mm"][1], len(vals))
        peak = float(vals.max()) or 1.0
        return {"values": (vals / peak).tolist(),
                "ax_mm": ax.tolist(), "peak": peak,
                "lateral_index": ix}

    def stats_json(self) -> dict:
        from .params.enums import ShaderKind
        stats = self.beamformer.stats
        avgs = stats.average_times()
        stages = []
        for i, sid in enumerate(stats.table.shader_ids):
            if sid < 0:
                break
            stages.append({"name": ShaderKind(int(sid)).name,
                           "avg_ms": float(avgs[i]) * 1e3})
        return {"stages": stages,
                "frame_ms": stats.average_frame_time() * 1e3,
                "rf_delta_ms": stats.average_rf_delta() * 1e3}

    # -- 3D X-plane view (ui.c:913-1068 counterpart) ---------------------

    def _volume(self, db_cutoff=-60.0, gamma=1.0):
        from .viewer_xplane import volume_bmode
        frames = self.beamformer.get_last_frames(1)
        if not frames:
            return np.zeros((2, 2, 2), np.float32)
        return volume_bmode(frames[-1], db_cutoff=db_cutoff, gamma=gamma)

    def xplane_png(self, offsets, yaw=0.6, pitch=0.45, size=512,
                   db_cutoff=-60.0, gamma=1.0) -> bytes:
        from .viewer_xplane import render_xplane
        img = render_xplane(self._volume(db_cutoff, gamma), offsets,
                            yaw=yaw, pitch=pitch, size=size)
        return encode_png_gray(img)

    def slice_png(self, axis=2, frac=0.5, db_cutoff=-60.0,
                  gamma=1.0) -> bytes:
        from .viewer_xplane import slice_volume
        img = slice_volume(self._volume(db_cutoff, gamma), int(axis),
                           float(frac))
        return encode_png_gray(img)

    def mip_png(self, yaw=0.6, pitch=0.45, size=256, db_cutoff=-60.0,
                gamma=1.0) -> bytes:
        """Maximum-intensity projection of the latest volume."""
        from .viewer_xplane import render_mip
        img = render_mip(self._volume(db_cutoff, gamma), yaw=yaw,
                         pitch=pitch, size=size)
        return encode_png_gray(img)

    def oblique_png(self, center, normal, size=256, db_cutoff=-60.0,
                    gamma=1.0) -> bytes:
        """Oblique (non-axis-aligned) slice through the latest volume."""
        from .viewer_xplane import oblique_slice
        img = oblique_slice(self._volume(db_cutoff, gamma), center, normal,
                            size=size)
        return encode_png_gray(img)

    def pick(self, body: dict) -> dict:
        from .viewer_xplane import pick_plane
        hit = pick_plane(body["offsets"], float(body["yaw"]),
                         float(body["pitch"]), float(body["x"]),
                         float(body["y"]), int(body.get("size", 512)))
        return {"axis": None if hit is None else int(hit[0])}

    def drag(self, body: dict) -> dict:
        from .viewer_xplane import drag_plane
        offsets = list(body["offsets"])
        axis = int(body["axis"])
        offsets[axis] = drag_plane(offsets, axis, float(body["yaw"]),
                                   float(body["pitch"]), float(body["dx"]),
                                   float(body["dy"]),
                                   int(body.get("size", 512)))
        return {"offsets": offsets}

    # -- parameter editing (dirty-region writeback, ui.c:5272-5326) ------

    _EDITABLE = ("f_number", "speed_of_sound", "demodulation_frequency",
                 "sampling_frequency", "time_offset")

    def params_json(self, block: int = 0) -> dict:
        p = self.beamformer._block(block).parameters
        return {k: float(getattr(p, k)) for k in self._EDITABLE}

    def apply_params(self, body: dict, block: int = 0) -> dict:
        """Live parameter edit: update the block and mark it dirty — the
        next frame re-plans (numeric fields are traced, so no recompile)."""
        b = self.beamformer._block(block)
        p = b.parameters
        for k, val in body.items():
            if k in self._EDITABLE:
                setattr(p, k, float(val))
        self.beamformer.push_parameters(p, block=block)
        return self.params_json(block)

    def apply_live(self, body: dict) -> dict:
        live = self.beamformer.live_parameters
        flags = 0
        if "transmit_power" in body:
            live.transmit_power = float(body["transmit_power"])
            flags |= LiveImagingDirtyFlags.TransmitPower
        if body.get("stop"):
            live.active = 0
            flags |= LiveImagingDirtyFlags.StopImaging
        self.beamformer.set_live_parameters(live, int(flags))
        return {"ok": True, "flags": int(flags)}

    # -- server ---------------------------------------------------------

    def start(self):
        view = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    self._get()
                except BrokenPipeError:
                    pass
                except (ValueError, KeyError, ZeroDivisionError) as e:
                    # malformed query values must yield a 4xx, not a
                    # dropped connection with a server-side traceback
                    self._send(400, "text/plain",
                               f"bad request: {e}".encode())

            @staticmethod
            def _int(q, key, default, lo, hi):
                return min(hi, max(lo, int(q.get(key, default))))

            def _get(self):
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/frame.png":
                    png = view.frame_png(
                        db_cutoff=float(q.get("db", -60)),
                        gamma=float(q.get("gamma", 1.0)),
                        plane=q.get("plane", "xz"),
                        x0=float(q.get("x0", 0)), y0=float(q.get("y0", 0)),
                        x1=float(q.get("x1", 1)), y1=float(q.get("y1", 1)),
                        out=self._int(q, "out", 0, 0, 1024))
                    self._send(200, "image/png", png)
                elif url.path == "/frame_meta.json":
                    self._send(200, "application/json", json.dumps(
                        view.frame_meta_json(q.get("plane", "xz"))).encode())
                elif url.path == "/ascan.json":
                    self._send(200, "application/json", json.dumps(
                        view.ascan_json(frac=float(q.get("frac", 0.5)),
                                        plane=q.get("plane", "xz"))).encode())
                elif url.path == "/stats.json":
                    self._send(200, "application/json",
                               json.dumps(view.stats_json()).encode())
                elif url.path == "/xplane":
                    self._send(200, "text/html", _XPLANE_PAGE.encode())
                elif url.path == "/panels":
                    self._send(200, "text/html", _PANELS_PAGE.encode())
                elif url.path == "/xplane.png":
                    png = view.xplane_png(
                        offsets=[float(q.get("ox", 0)),
                                 float(q.get("oy", 0)),
                                 float(q.get("oz", 0))],
                        yaw=float(q.get("yaw", 0.6)),
                        pitch=float(q.get("pitch", 0.45)),
                        size=self._int(q, "size", 512, 16, 512),
                        db_cutoff=float(q.get("db", -60)),
                        gamma=float(q.get("gamma", 1.0)))
                    self._send(200, "image/png", png)
                elif url.path == "/mip.png":
                    png = view.mip_png(
                        yaw=float(q.get("yaw", 0.6)),
                        pitch=float(q.get("pitch", 0.45)),
                        size=self._int(q, "size", 256, 16, 512),
                        db_cutoff=float(q.get("db", -60)),
                        gamma=float(q.get("gamma", 1.0)))
                    self._send(200, "image/png", png)
                elif url.path == "/oblique.png":
                    png = view.oblique_png(
                        center=[float(q.get("cx", 0)),
                                float(q.get("cy", 0)),
                                float(q.get("cz", 0))],
                        normal=[float(q.get("nx", 0)),
                                float(q.get("ny", 0)),
                                float(q.get("nz", 1))],
                        size=self._int(q, "size", 256, 16, 512),
                        db_cutoff=float(q.get("db", -60)),
                        gamma=float(q.get("gamma", 1.0)))
                    self._send(200, "image/png", png)
                elif url.path == "/slice.png":
                    png = view.slice_png(
                        axis=int(q.get("axis", 2)),
                        frac=float(q.get("frac", 0.5)),
                        db_cutoff=float(q.get("db", -60)),
                        gamma=float(q.get("gamma", 1.0)))
                    self._send(200, "image/png", png)
                elif url.path == "/params":
                    self._send(200, "application/json",
                               json.dumps(view.params_json()).encode())
                elif url.path == "/live":
                    import dataclasses
                    live = view.beamformer.live_parameters
                    payload = {f.name: getattr(live, f.name)
                               for f in dataclasses.fields(live)
                               if not isinstance(getattr(live, f.name),
                                                 np.ndarray)}
                    self._send(200, "application/json",
                               json.dumps(payload).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                try:
                    self._post()
                except BrokenPipeError:
                    pass
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, "text/plain",
                               f"bad request: {e}".encode())

            def _post(self):
                path = urlparse(self.path).path
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if path == "/live":
                    out = view.apply_live(body)
                elif path == "/pick":
                    out = view.pick(body)
                elif path == "/drag":
                    out = view.drag(body)
                elif path == "/params":
                    out = view.apply_params(body)
                else:
                    self._send(404, "text/plain", b"not found")
                    return
                self._send(200, "application/json", json.dumps(out).encode())

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="live-view")
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
