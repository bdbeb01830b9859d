"""Self-contained interactive 3D point-cloud viewer (counterpart of
omnivggt_tpu/viz/server.py; the same page and the same /data bytes).

A single-page raw-WebGL viewer served from the Python stdlib http.server: no
external dependency, works offline. Controls: orbit (drag), zoom (wheel),
pan (right-drag/shift-drag), a confidence-percentile slider, a frame filter
dropdown, point-size slider, camera-frusta toggle, background masks, and a
click on a frustum flies the view to that camera.

Data is shipped to the page as binary (positions f32, colors u8, per-point conf
f32, per-point frame id f32, camera segments, poses, textured-frustum quads and
a thumbnail atlas) via a single /data endpoint.
"""

from __future__ import annotations

import http.server
import socketserver
import struct
import threading
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>omnivggt-tpu viewer</title>
<style>
 body{margin:0;overflow:hidden;background:#111;font-family:sans-serif}
 #hud{position:absolute;top:10px;left:10px;color:#eee;background:#0008;
      padding:10px;border-radius:8px;font-size:13px}
 #hud label{display:block;margin:4px 0}
 canvas{display:block}
</style></head><body>
<div id="hud">
 <b>omnivggt-tpu</b>
 <label>conf percentile <input id="conf" type="range" min="0" max="100" value="CONF0"> <span id="confv">CONF0</span></label>
 <label>point size <input id="psize" type="range" min="1" max="8" value="2"></label>
 <label>frame <select id="frame"><option value="-1">all</option></select></label>
 <label><input id="cams" type="checkbox" checked> show cameras</label>
 <label><input id="mblack" type="checkbox"MB0> mask black bg</label>
 <label><input id="mwhite" type="checkbox"MW0> mask white bg</label>
 <span id="stats"></span>
</div>
<canvas id="c"></canvas>
<script>
const canvas=document.getElementById('c');
const gl=canvas.getContext('webgl');
let N=0,S=0,pos,col,conf,fid,camsegs=null,confSorted,campose=null,sceneR=1,tween=null;
const st={rx:-0.5,ry:0.5,dist:3,cx:0,cy:0,cz:0,px:0,py:0};
function resize(){canvas.width=innerWidth;canvas.height=innerHeight;gl.viewport(0,0,canvas.width,canvas.height);}
addEventListener('resize',resize);resize();
// background filters match the reference viewer's masks:
// black bg drops color sums < 16/255, white bg drops all-channels > 240/255;
// the conf>0.1 floor mirrors the reference viewer's initial conf mask
const vs=`attribute vec3 p;attribute vec3 c;attribute float cf;attribute float fi;
uniform mat4 mvp;uniform float thr;uniform float psz;uniform float frame;
uniform float ub;uniform float uw;
varying vec3 vc;varying float vis;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=psz;vc=c;
 float lum=(c.r+c.g+c.b)*255.0;
 bool white=c.r*255.0>240.0&&c.g*255.0>240.0&&c.b*255.0>240.0;
 vis=(cf>=thr&&cf>0.1&&(frame<0.0||abs(fi-frame)<0.5)
      &&(ub<0.5||lum>=16.0)&&(uw<0.5||!white))?1.0:0.0;
 if(vis<0.5)gl_Position=vec4(2e9,2e9,2e9,1.0);}`;
const fs=`precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.0);}`;
const lvs=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);vc=c;}`;
function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);
 if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))console.error(gl.getShaderInfoLog(h));return h;}
function prog(v,f){const p=gl.createProgram();gl.attachShader(p,sh(gl.VERTEX_SHADER,v));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,f));gl.linkProgram(p);return p;}
// textured camera frusta (the reference viewer's frusta carry their image):
// one atlas texture, two triangles per camera
const tvs=`attribute vec3 p;attribute vec2 t;uniform mat4 mvp;varying vec2 vt;
void main(){gl_Position=mvp*vec4(p,1.0);vt=t;}`;
const tfs=`precision mediump float;varying vec2 vt;uniform sampler2D tex;
void main(){gl_FragColor=vec4(texture2D(tex,vt).rgb,1.0);}`;
const P=prog(vs,fs),LP=prog(lvs,fs),TP=prog(tvs,tfs);
let bufs={},lineBufs=null,nLines=0,quadBufs=null,nQuadVerts=0,frustumTex=null;
function mul(a,b){const o=new Array(16).fill(0);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)o[j*4+i]+=a[k*4+i]*b[j*4+k];return o;}
function mvp(){
 const a=canvas.width/canvas.height,f=1.8,n=0.01,fa=1000;
 const pm=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
 const cx=Math.cos(st.rx),sx=Math.sin(st.rx),cy=Math.cos(st.ry),sy=Math.sin(st.ry);
 const R1=[1,0,0,0, 0,cx,sx,0, 0,-sx,cx,0, 0,0,0,1];
 const R2=[cy,0,-sy,0, 0,1,0,0, sy,0,cy,0, 0,0,0,1];
 const T=[1,0,0,0, 0,1,0,0, 0,0,1,0, -st.cx+st.px,-st.cy+st.py,-st.cz,1];
 const Z=[1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,-st.dist,1];
 return mul(pm,mul(Z,mul(R1,mul(R2,T))));}
canvas.addEventListener('mousedown',e=>{tween=null;st.drag=e.button; st.lx=e.clientX;st.ly=e.clientY;
 st.dx0=e.clientX;st.dy0=e.clientY;e.preventDefault();});
addEventListener('mouseup',e=>{
 if(st.drag===0&&Math.abs(e.clientX-st.dx0)<4&&Math.abs(e.clientY-st.dy0)<4)pickCamera(e.clientX,e.clientY);
 st.drag=undefined;});
// click a camera frustum to fly the view to that camera's pose
// (parity with the reference viewer's per-frustum click handler)
function pickCamera(x,y){
 if(!campose)return;
 const m=mvp();let best=-1,bd=20;  // 20 px pick radius
 for(let s=0;s<S;s++){
  const px=campose[6*s],py=campose[6*s+1],pz=campose[6*s+2];
  const dx=campose[6*s+3],dy=campose[6*s+4],dz=campose[6*s+5];
  if(dx===0&&dy===0&&dz===0)continue;
  const w=m[3]*px+m[7]*py+m[11]*pz+m[15];
  if(w<=0)continue;
  const sx=((m[0]*px+m[4]*py+m[8]*pz+m[12])/w*0.5+0.5)*canvas.width;
  const sy=(0.5-(m[1]*px+m[5]*py+m[9]*pz+m[13])/w*0.5)*canvas.height;
  const d=Math.hypot(sx-x,sy-y);
  if(d<bd){bd=d;best=s;}}
 if(best<0)return;
 const p=[campose[6*best],campose[6*best+1],campose[6*best+2]];
 let d=[campose[6*best+3],campose[6*best+4],campose[6*best+5]];
 const dn=Math.hypot(d[0],d[1],d[2])||1;d=d.map(v=>v/dn);
 // orbit params reproducing eye=p, forward=d (view forward
 // = R2^T R1^T (0,0,-1) = (cx*sy, -sx, -cx*cy))
 const d0=Math.max(sceneR*0.35,1e-3);
 const to={rx:Math.asin(Math.max(-1,Math.min(1,-d[1]))),
           ry:Math.atan2(d[0],-d[2]),dist:d0,
           cx:p[0]+d[0]*d0,cy:p[1]+d[1]*d0,cz:p[2]+d[2]*d0,px:0,py:0};
 // shortest-path angular interpolation
 const TAU=Math.PI*2;
 to.ry=st.ry+((to.ry-st.ry)%TAU+TAU*1.5)%TAU-TAU*0.5;
 const from={...st},t0=performance.now();
 tween=()=>{const u=Math.min(1,(performance.now()-t0)/600);
  const e=u*u*(3-2*u);  // smoothstep
  for(const k of ['rx','ry','dist','cx','cy','cz','px','py'])
   st[k]=from[k]+(to[k]-from[k])*e;
  if(u>=1)tween=null;};
}
canvas.addEventListener('contextmenu',e=>e.preventDefault());
addEventListener('mousemove',e=>{if(st.drag===undefined)return;
 const dx=e.clientX-st.lx,dy=e.clientY-st.ly;st.lx=e.clientX;st.ly=e.clientY;
 if(st.drag===0&&!e.shiftKey){st.ry+=dx*0.005;st.rx+=dy*0.005;}
 else{st.px+=dx*0.002*st.dist;st.py-=dy*0.002*st.dist;}});
canvas.addEventListener('wheel',e=>{tween=null;st.dist*=Math.exp(e.deltaY*0.001);e.preventDefault();});
function draw(){
 if(tween)tween();
 gl.clearColor(0.07,0.07,0.08,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);
 if(N){
  gl.useProgram(P);
  const m=mvp();gl.uniformMatrix4fv(gl.getUniformLocation(P,'mvp'),false,new Float32Array(m));
  const pct=+document.getElementById('conf').value;
  document.getElementById('confv').textContent=pct;
  const thr=pct<=0?-1e30:confSorted[Math.min(N-1,Math.floor(pct/100*(N-1)))];
  gl.uniform1f(gl.getUniformLocation(P,'thr'),thr);
  gl.uniform1f(gl.getUniformLocation(P,'psz'),+document.getElementById('psize').value);
  gl.uniform1f(gl.getUniformLocation(P,'frame'),+document.getElementById('frame').value);
  gl.uniform1f(gl.getUniformLocation(P,'ub'),document.getElementById('mblack').checked?1.0:0.0);
  gl.uniform1f(gl.getUniformLocation(P,'uw'),document.getElementById('mwhite').checked?1.0:0.0);
  const bind=(name,buf,size,type,norm)=>{const l=gl.getAttribLocation(P,name);
   gl.bindBuffer(gl.ARRAY_BUFFER,buf);gl.enableVertexAttribArray(l);
   gl.vertexAttribPointer(l,size,type,norm,0,0);};
  bind('p',bufs.p,3,gl.FLOAT,false);bind('c',bufs.c,3,gl.UNSIGNED_BYTE,true);
  bind('cf',bufs.cf,1,gl.FLOAT,false);bind('fi',bufs.fi,1,gl.FLOAT,false);
  gl.drawArrays(gl.POINTS,0,N);
  if(lineBufs&&document.getElementById('cams').checked){
   gl.useProgram(LP);
   gl.uniformMatrix4fv(gl.getUniformLocation(LP,'mvp'),false,new Float32Array(m));
   const l=gl.getAttribLocation(LP,'p');gl.bindBuffer(gl.ARRAY_BUFFER,lineBufs.p);
   gl.enableVertexAttribArray(l);gl.vertexAttribPointer(l,3,gl.FLOAT,false,0,0);
   const lc=gl.getAttribLocation(LP,'c');gl.bindBuffer(gl.ARRAY_BUFFER,lineBufs.c);
   gl.enableVertexAttribArray(lc);gl.vertexAttribPointer(lc,3,gl.UNSIGNED_BYTE,true,0,0);
   gl.drawArrays(gl.LINES,0,nLines);}
  if(quadBufs&&frustumTex&&document.getElementById('cams').checked){
   gl.useProgram(TP);
   gl.uniformMatrix4fv(gl.getUniformLocation(TP,'mvp'),false,new Float32Array(m));
   gl.activeTexture(gl.TEXTURE0);gl.bindTexture(gl.TEXTURE_2D,frustumTex);
   gl.uniform1i(gl.getUniformLocation(TP,'tex'),0);
   const qp=gl.getAttribLocation(TP,'p');gl.bindBuffer(gl.ARRAY_BUFFER,quadBufs.p);
   gl.enableVertexAttribArray(qp);gl.vertexAttribPointer(qp,3,gl.FLOAT,false,0,0);
   const qt=gl.getAttribLocation(TP,'t');gl.bindBuffer(gl.ARRAY_BUFFER,quadBufs.t);
   gl.enableVertexAttribArray(qt);gl.vertexAttribPointer(qt,2,gl.FLOAT,false,0,0);
   gl.drawArrays(gl.TRIANGLES,0,nQuadVerts);}
 }
 requestAnimationFrame(draw);}
fetch('data').then(r=>r.arrayBuffer()).then(ab=>{
 const dv=new DataView(ab);let o=0;
 N=dv.getUint32(o,true);o+=4;S=dv.getUint32(o,true);o+=4;
 const nl=dv.getUint32(o,true);o+=4;
 pos=new Float32Array(ab,o,N*3);o+=N*12;
 col=new Uint8Array(ab,o,N*3);o+=N*3;o+=(4-o%4)%4;
 conf=new Float32Array(ab,o,N);o+=N*4;
 fid=new Float32Array(ab,o,N);o+=N*4;
 const lp=new Float32Array(ab,o,nl*6);o+=nl*24;
 const lc=new Uint8Array(ab,o,nl*6);o+=nl*6;o+=(4-o%4)%4;
 let quads=null,tmeta=null,atlas=null;
 if(o+S*24<=ab.byteLength){campose=new Float32Array(ab,o,S*6);o+=S*24;}
 if(o+S*48+16<=ab.byteLength){
  quads=new Float32Array(ab,o,S*12);o+=S*48;
  tmeta=[dv.getUint32(o,true),dv.getUint32(o+4,true),
         dv.getUint32(o+8,true),dv.getUint32(o+12,true)];o+=16;
  if(tmeta[0]&&tmeta[1]){
   const aw=tmeta[2]*tmeta[0],ah=tmeta[3]*tmeta[1];
   atlas=new Uint8Array(ab,o,aw*ah*3);o+=aw*ah*3;}}
 confSorted=Float32Array.from(conf).sort();
 // center/scale
 let mx=0,my=0,mz=0;for(let i=0;i<N;i++){mx+=pos[3*i];my+=pos[3*i+1];mz+=pos[3*i+2];}
 st.cx=mx/N;st.cy=my/N;st.cz=mz/N;
 let r=0;for(let i=0;i<Math.min(N,10000);i++){const dx=pos[3*i]-st.cx,dy=pos[3*i+1]-st.cy,dz=pos[3*i+2]-st.cz;
  r=Math.max(r,Math.sqrt(dx*dx+dy*dy+dz*dz));}
 st.dist=r*1.5||3;sceneR=r||1;
 const sel=document.getElementById('frame');
 for(let s=0;s<S;s++){const op=document.createElement('option');op.value=s;op.textContent='frame '+s;sel.appendChild(op);}
 const mk=(d)=>{const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);gl.bufferData(gl.ARRAY_BUFFER,d,gl.STATIC_DRAW);return b;};
 bufs={p:mk(pos),c:mk(col),cf:mk(conf),fi:mk(fid)};
 if(nl){lineBufs={p:mk(lp),c:mk(lc)};nLines=nl*2;}
 if(quads&&atlas){
  const[tw,th,tc]=tmeta,aw=tc*tw,ah=tmeta[3]*th;
  frustumTex=gl.createTexture();
  gl.bindTexture(gl.TEXTURE_2D,frustumTex);
  gl.pixelStorei(gl.UNPACK_ALIGNMENT,1);
  gl.texImage2D(gl.TEXTURE_2D,0,gl.RGB,aw,ah,0,gl.RGB,gl.UNSIGNED_BYTE,atlas);
  // NPOT atlas: clamp + linear, no mips (WebGL1 rule)
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MIN_FILTER,gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MAG_FILTER,gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_S,gl.CLAMP_TO_EDGE);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_T,gl.CLAMP_TO_EDGE);
  const qp=new Float32Array(S*18),qt=new Float32Array(S*12),idx=[0,1,2,0,2,3];
  for(let s=0;s<S;s++){
   const r=Math.floor(s/tc),c=s%tc;
   const u0=c*tw/aw,v0=r*th/ah,u1=(c+1)*tw/aw,v1=(r+1)*th/ah;
   const uv=[[u0,v0],[u1,v0],[u1,v1],[u0,v1]];
   for(let k=0;k<6;k++){const j=idx[k];
    qp[s*18+k*3]=quads[s*12+j*3];qp[s*18+k*3+1]=quads[s*12+j*3+1];
    qp[s*18+k*3+2]=quads[s*12+j*3+2];
    qt[s*12+k*2]=uv[j][0];qt[s*12+k*2+1]=uv[j][1];}}
  quadBufs={p:mk(qp),t:mk(qt)};nQuadVerts=S*6;}
 document.getElementById('stats').textContent=N.toLocaleString()+' pts, '+S+' frames';
 draw();});
</script></body></html>"""


def build_payload(
    points, colors, conf, frame_ids, n_frames, cam_segments, cam_colors,
    cam_poses=None, cam_quads=None, atlas=None, thumb_shape=None,
):
    """Binary payload matching the viewer's /data parser.

    cam_poses: optional (n_frames, 6) float32 [position, view direction] per
    camera, in the (recentered) world frame: powers the click-frustum-to-
    set-viewpoint interaction. Zeros disable picking for a camera.

    cam_quads: optional (n_frames, 4, 3) float32 far-plane corners per
    camera: the geometry for the image-textured frusta. Zeros draw nothing
    (degenerate quads).

    atlas / thumb_shape: optional uint8 RGB thumbnail atlas + its
    (tw, th, cols, rows) grid metadata, produced by thumbnail_atlas().
    """
    n = len(points)
    nl = len(cam_segments)
    out = bytearray()
    out += struct.pack("<III", n, n_frames, nl)
    out += np.ascontiguousarray(points, np.float32).tobytes()
    out += np.ascontiguousarray(colors, np.uint8).tobytes()
    out += b"\x00" * ((4 - len(out) % 4) % 4)
    out += np.ascontiguousarray(conf, np.float32).tobytes()
    out += np.ascontiguousarray(frame_ids, np.float32).tobytes()
    out += np.ascontiguousarray(cam_segments, np.float32).tobytes()  # (nl, 2, 3)
    out += np.ascontiguousarray(cam_colors, np.uint8).tobytes()  # (nl, 2, 3)
    out += b"\x00" * ((4 - len(out) % 4) % 4)
    if cam_poses is None:
        cam_poses = np.zeros((n_frames, 6), np.float32)
    out += np.ascontiguousarray(cam_poses, np.float32).tobytes()  # (S, 6)
    if cam_quads is None:
        cam_quads = np.zeros((n_frames, 4, 3), np.float32)
    out += np.ascontiguousarray(cam_quads, np.float32).tobytes()  # (S, 4, 3)
    if atlas is None:
        out += struct.pack("<IIII", 0, 0, 0, 0)
    else:
        tw, th, cols, rows = thumb_shape
        out += struct.pack("<IIII", tw, th, cols, rows)
        out += np.ascontiguousarray(atlas, np.uint8).tobytes()
    return bytes(out)


def thumbnail_atlas(images: np.ndarray, max_h: int = 64):
    """Downscale (S, H, W, 3) float [0,1] frames into one uint8 RGB grid
    atlas for the textured frusta (one WebGL texture for all frames).
    Returns (atlas, (tw, th, cols, rows))."""
    S, H, W = images.shape[:3]
    step = max(1, -(-H // max_h))  # ceil div: thumbnail height <= max_h
    thumbs = (np.clip(images[:, ::step, ::step], 0.0, 1.0) * 255).astype(
        np.uint8
    )
    th, tw = thumbs.shape[1:3]
    cols = int(np.ceil(np.sqrt(S)))
    rows = -(-S // cols)
    atlas = np.zeros((rows * th, cols * tw, 3), np.uint8)
    for s in range(S):
        r, c = divmod(s, cols)
        atlas[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = thumbs[s]
    return atlas, (tw, th, cols, rows)


def _frustum_corners(scene_scale: float, aspect: float = 1.0) -> np.ndarray:
    """Far-plane corners of a camera frustum in camera coords (+z forward),
    matching the reference's frustum proportions: fov = 2*atan2(h/2, 1.1h)
    (tan(fov/2) = 1/2.2) at aspect w/h."""
    d = scene_scale * 0.05
    hh = d / 2.2
    hw = hh * aspect
    return np.array(
        [[-hw, -hh, d], [hw, -hh, d], [hw, hh, d], [-hw, hh, d]], np.float32
    )


def camera_quads(
    extrinsics_w2c: np.ndarray, scene_scale: float, aspect: float = 1.0
) -> np.ndarray:
    """(S, 4, 3) world-space far-plane corners per camera — the textured
    frustum geometry. Corner order matches image corners TL, TR, BR, BL in
    the OpenCV convention (+x right, +y down), i.e. uv (0,0),(1,0),(1,1),
    (0,1) with v pointing down the image."""
    corners = _frustum_corners(scene_scale, aspect)
    n = len(extrinsics_w2c)
    if n == 0:
        return np.zeros((0, 4, 3), np.float32)
    out = np.empty((n, 4, 3), np.float32)
    for i in range(n):
        E = np.eye(4)
        E[:3, :4] = extrinsics_w2c[i]
        c2w = np.linalg.inv(E)
        out[i] = corners @ c2w[:3, :3].T + c2w[:3, 3]
    return out


def camera_wire_segments(
    extrinsics_w2c: np.ndarray, scene_scale: float, aspect: float = 1.0
):
    """Wireframe frusta line segments for the viewer, one color per camera."""
    from omnivggt_tpu_torch.viz.glb import _rainbow

    segs, cols = [], []
    n = len(extrinsics_w2c)
    corners = _frustum_corners(scene_scale, aspect)
    for i in range(n):
        E = np.eye(4)
        E[:3, :4] = extrinsics_w2c[i]
        c2w = np.linalg.inv(E)
        R, t = c2w[:3, :3], c2w[:3, 3]
        apex = t
        pts = corners @ R.T + t
        color = _rainbow(i / max(n, 1))
        for j in range(4):
            segs.append([apex, pts[j]])
            segs.append([pts[j], pts[(j + 1) % 4]])
            cols.extend([[color, color], [color, color]])
    if not segs:
        return np.zeros((0, 2, 3), np.float32), np.zeros((0, 2, 3), np.uint8)
    return np.asarray(segs, np.float32), np.asarray(cols, np.uint8)


def _scene_payload(predictions: dict, use_point_map: bool = False) -> bytes:
    """The viewer's /data for a prediction dict (see serve_scene): points
    recentred on their median, cameras recentred with them, wire frusta,
    textured quads and the thumbnail atlas, through build_payload."""
    if use_point_map or "world_points_from_depth" not in predictions:
        pts = predictions["world_points"]
        conf = predictions["world_points_conf"]
    else:
        pts = predictions["world_points_from_depth"]
        conf = predictions.get("depth_conf", np.ones(pts.shape[:-1]))

    images = predictions["images"]
    if images.ndim == 4 and images.shape[1] == 3:
        images = np.transpose(images, (0, 2, 3, 1))
    S, H, W = pts.shape[:3]
    points = pts.reshape(-1, 3).astype(np.float32)
    colors = (images.reshape(-1, 3) * 255).astype(np.uint8)
    conf_flat = conf.reshape(-1).astype(np.float32)
    frame_ids = np.repeat(np.arange(S, dtype=np.float32), H * W)

    center = np.median(points, axis=0)
    points = points - center
    lo, hi = np.percentile(points, 5, axis=0), np.percentile(points, 95, axis=0)
    scene_scale = float(np.linalg.norm(hi - lo))

    ex = predictions["extrinsic"].copy()
    # recenter cameras consistently with the points
    E = np.tile(np.eye(4), (S, 1, 1))
    E[:, :3, :4] = ex
    c2w = np.linalg.inv(E)
    c2w[:, :3, 3] -= center
    ex_centered = np.linalg.inv(c2w)[:, :3, :4]
    aspect = W / H
    segs, seg_cols = camera_wire_segments(ex_centered, scene_scale, aspect)
    quads = camera_quads(ex_centered, scene_scale, aspect)
    atlas, thumb_shape = thumbnail_atlas(images)

    # per-camera [position, +z view direction] for click-to-set-viewpoint
    cam_poses = np.concatenate(
        [c2w[:, :3, 3], c2w[:, :3, 2]], axis=-1
    ).astype(np.float32)

    return build_payload(
        points, colors, conf_flat, frame_ids, S, segs, seg_cols, cam_poses,
        cam_quads=quads, atlas=atlas, thumb_shape=thumb_shape,
    )


def serve_scene(
    predictions: dict,
    port: int = 8080,
    init_conf_threshold: float = 25.0,
    background_mode: bool = False,
    use_point_map: bool = False,
    mask_black_bg: bool = False,
    mask_white_bg: bool = False,
) -> Optional[threading.Thread]:
    """Serve the interactive viewer for a (batch-dim-removed, numpy) prediction
    dict with keys world_points / world_points_conf / images / extrinsic (and
    world_points_from_depth when use_point_map is False).

    mask_black_bg / mask_white_bg set the initial state of the viewer's
    background-filter checkboxes (drop points with color sum < 16 / all
    channels > 240); the filters run in the point shader like the
    confidence slider, so toggling is instant.

    With background_mode the server runs on a daemon thread, which is
    returned; its `httpd` attribute is the server, for the caller to shut
    down."""
    payload = _scene_payload(predictions, use_point_map)
    page = (
        _PAGE.replace("CONF0", str(int(init_conf_threshold)))
        .replace("MB0", " checked" if mask_black_bg else "")
        .replace("MW0", " checked" if mask_white_bg else "")
    )

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") in ("", "/index.html"):
                body = page.encode()
                ctype = "text/html"
            elif self.path.lstrip("/") == "data":
                body = payload
                ctype = "application/octet-stream"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    socketserver.ThreadingTCPServer.allow_reuse_address = True  # TIME_WAIT
    httpd = socketserver.ThreadingTCPServer(("0.0.0.0", port), Handler)
    httpd.daemon_threads = True
    print(f"viewer running at http://localhost:{httpd.server_address[1]}")
    if background_mode:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.httpd = httpd
        t.start()
        return t
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
    return None
