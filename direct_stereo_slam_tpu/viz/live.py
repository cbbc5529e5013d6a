"""Live visualization: a self-refreshing HTML viewer.

Headless stand-in for the reference's Pangolin GUI
(pangolin_viewer/PangolinLoopViewer.{h,cpp}: three panes — trajectory +
cloud, KF depth image, lidar scan — plus loop-aware cloud re-posing via
``modifyKeyframePoseByKFID`` and green/red current-vs-matched scan display
via ``refreshLidarData``). A GL window cannot exist on a headless server;
instead the viewer rewrites ONE self-contained ``live.html`` (inline JSON
+ canvas JS, <meta refresh>) at a bounded rate. Open it in any browser
(file:// or through ``python -m http.server``) and watch the run: the
trajectory grows, the rolling cloud follows, loop closures visibly re-pose
past keyframes (poses are stored per-KF and points in camera frame, so a
pose-graph update moves the whole history, exactly like the reference's
``modifyKeyframePoseByKFID``), and the latest matched scan pair renders
green/red.

Per-KF state is bounded (MAX_KFS / PTS_PER_KF) so the file stays ~1 MB on
multi-thousand-frame runs."""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

MAX_KFS = 400          # newest keyframes kept in the view
PTS_PER_KF = 120       # cloud points kept per keyframe (camera frame)
SCAN_PTS = 600         # points per displayed scan
MIN_REFRESH_S = 0.5    # file rewrite rate bound


class LiveViewer:
    """Thread-safe accumulator + HTML writer. All hooks are cheap and
    non-blocking except the rate-limited file rewrite."""

    def __init__(self, path: str, title: str = "direct_stereo_slam_tpu"):
        self.path = path
        self.title = title
        self._lock = threading.Lock()
        self._kf_pose: Dict[int, np.ndarray] = {}     # kf_id -> T_wc [4,4]
        self._kf_pts: Dict[int, np.ndarray] = {}      # kf_id -> [K,3] cam
        self._cam_trail = []                          # per-frame positions
        self._scan_cur = np.zeros((0, 3))
        self._scan_matched = np.zeros((0, 3))
        self._depth_b64 = ""
        self._loops = []                              # (id_a, id_b)
        self._n_loops_direct = 0
        self._n_loops_icp = 0
        self._last_write = 0.0
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)

    # ---- hooks (reference Output3DWrapper surface) -----------------------

    def publish_cam_pose(self, T_wc: np.ndarray):
        with self._lock:
            self._cam_trail.append(
                np.asarray(T_wc, np.float32)[:3, 3].copy())
        self._maybe_write()

    def publish_keyframe(self, kf_id: int, T_wc: np.ndarray,
                         pts_cam: Optional[np.ndarray] = None):
        """KeyFrameDisplay::setFromKF: store pose + a subsampled camera-
        frame cloud (final/marginalized publish, PangolinLoopViewer
        consumes final-only, cpp:151-175)."""
        with self._lock:
            self._kf_pose[int(kf_id)] = np.asarray(T_wc, np.float32).copy()
            if pts_cam is not None and len(pts_cam):
                p = np.asarray(pts_cam, np.float32)
                if len(p) > PTS_PER_KF:
                    p = p[:: max(1, len(p) // PTS_PER_KF)][:PTS_PER_KF]
                self._kf_pts[int(kf_id)] = p
            while len(self._kf_pose) > MAX_KFS:
                oldest = min(self._kf_pose)
                self._kf_pose.pop(oldest, None)
                self._kf_pts.pop(oldest, None)
        self._maybe_write()

    def modify_keyframe_poses(self, poses: Dict[int, np.ndarray],
                              loop_pair=None, n_direct=0, n_icp=0):
        """modifyKeyframePoseByKFID (cpp:177-182): the pose-graph result
        re-poses every stored keyframe cloud."""
        with self._lock:
            for kf_id, T in poses.items():
                if int(kf_id) in self._kf_pose:
                    self._kf_pose[int(kf_id)] = np.asarray(T, np.float32)
            if loop_pair is not None:
                self._loops.append((int(loop_pair[0]), int(loop_pair[1])))
            self._n_loops_direct = n_direct
            self._n_loops_icp = n_icp
        self._maybe_write(force=True)

    def refresh_lidar_data(self, scan_cur: np.ndarray,
                           scan_matched: Optional[np.ndarray] = None):
        """refreshLidarData (cpp:184-205): green current / red matched."""
        def sub(p):
            p = np.asarray(p, np.float32)
            if len(p) > SCAN_PTS:
                p = p[:: max(1, len(p) // SCAN_PTS)][:SCAN_PTS]
            return p
        with self._lock:
            self._scan_cur = sub(scan_cur)
            self._scan_matched = (sub(scan_matched)
                                  if scan_matched is not None
                                  else np.zeros((0, 3)))
        self._maybe_write()

    def publish_depth_image(self, rgb: np.ndarray):
        """pushDepthImage equivalent (the reference viewer's live KF
        depth pane, PangolinLoopViewer KF depth image): store the latest
        jet idepth overlay as an embedded PNG."""
        import base64

        from ..utils.imageio import encode_png

        png = encode_png(rgb)
        with self._lock:
            self._depth_b64 = base64.b64encode(png).decode("ascii")
        self._maybe_write()

    # ---- rendering -------------------------------------------------------

    def _maybe_write(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_write < MIN_REFRESH_S:
            return
        self._last_write = now
        try:
            self.write()
        except Exception:
            pass   # viewing must never take down the pipeline

    def _state_json(self) -> str:
        with self._lock:
            r2 = lambda a: np.round(np.asarray(a, np.float64), 2).tolist()
            cloud = []
            kfs = []
            for kf_id, T in self._kf_pose.items():
                kfs.append([int(kf_id)] + r2(T[:3, 3]))
                pts = self._kf_pts.get(kf_id)
                if pts is not None and len(pts):
                    world = pts @ T[:3, :3].T + T[:3, 3]
                    cloud.append(r2(world))
            state = {
                "title": self.title,
                "time": time.strftime("%H:%M:%S"),
                "trail": r2(np.asarray(self._cam_trail[-4000:])
                            if self._cam_trail else np.zeros((0, 3))),
                "kfs": kfs,
                "cloud": [p for seg in cloud for p in seg],
                "scan_cur": r2(self._scan_cur),
                "scan_matched": r2(self._scan_matched),
                "loops": self._loops[-200:],
                "n_direct": self._n_loops_direct,
                "n_icp": self._n_loops_icp,
                "depth_png": self._depth_b64,
            }
        return json.dumps(state, separators=(",", ":"))

    def write(self):
        html = _HTML_TEMPLATE.replace("__STATE__", self._state_json())
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(html)
        os.replace(tmp, self.path)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>dsslam live</title>
<style>
 body{background:#14141e;color:#cfcfe0;font:13px monospace;margin:12px}
 canvas,img{background:#0b0b12;border:1px solid #333;margin-right:10px}
 .row{display:flex;flex-wrap:wrap} .pane{margin-right:14px;margin-bottom:10px}
 h3{margin:4px 0;color:#8fb3ff;font-size:13px}
 #hint{color:#667;font-size:11px}
</style></head><body>
<div id="hdr"></div>
<div class="row">
 <div class="pane"><h3>trajectory + cloud (3D — drag: orbit, wheel: zoom,
   dblclick: reset)</h3>
   <canvas id="map" width="640" height="540"></canvas></div>
 <div class="pane"><h3>current scan (green) vs matched (red)</h3>
   <canvas id="scan" width="380" height="540"></canvas></div>
 <div class="pane"><h3>latest KF inverse depth</h3>
   <img id="depth" style="max-width:420px"></div>
</div>
<div id="hint">auto-refreshes every second (paused while dragging);
view state persists across refreshes</div>
<script>
const S = __STATE__;
document.getElementById('hdr').textContent =
  S.title + '  |  ' + S.time + '  |  frames: ' + S.trail.length +
  '  kfs: ' + S.kfs.length + '  loops: ' + S.n_direct + ' direct + ' +
  S.n_icp + ' icp';
if (S.depth_png)
  document.getElementById('depth').src = 'data:image/png;base64,' + S.depth_png;

// ---- interactive 3D pane (orbit camera, persisted in localStorage) ----
const KEY = 'dsslam_cam_' + S.title;
const kfPos = {}; for (const k of S.kfs) kfPos[k[0]] = [k[1], k[2], k[3]];
function bbox(pts){
  if(!pts.length) return {c:[0,0,0], s:1};
  let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
  for(const p of pts) for(let i=0;i<3;i++){
    if(p[i]<lo[i])lo[i]=p[i]; if(p[i]>hi[i])hi[i]=p[i];}
  return {c:[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2],
          s:Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3)};
}
function defaultCam(){
  const b = bbox([].concat(S.cloud, S.trail));
  return {t:0.0, p:-1.25, d:b.s*1.6, cx:b.c[0], cy:b.c[1], cz:b.c[2]};
}
let cam; try{ cam = JSON.parse(localStorage.getItem(KEY)) || defaultCam(); }
catch(e){ cam = defaultCam(); }
function saveCam(){ try{ localStorage.setItem(KEY, JSON.stringify(cam)); }
                    catch(e){} }
const mapc = document.getElementById('map');
function proj(p){
  let x=p[0]-cam.cx, y=p[1]-cam.cy, z=p[2]-cam.cz;
  const ct=Math.cos(cam.t), st=Math.sin(cam.t);
  let x1=ct*x+st*z, z1=-st*x+ct*z;
  const cp=Math.cos(cam.p), sp=Math.sin(cam.p);
  let y1=cp*y-sp*z1, z2=sp*y+cp*z1 + cam.d;
  if (z2 < 0.05*cam.d) return null;
  const f = 1.0*mapc.height/z2;
  return [mapc.width/2 + f*x1, mapc.height/2 + f*y1];
}
function draw3d(){
  const g = mapc.getContext('2d');
  g.clearRect(0,0,mapc.width,mapc.height);
  g.fillStyle='#5f6f95';
  for(const p of S.cloud){const q=proj(p); if(q) g.fillRect(q[0]-1,q[1]-1,2,2);}
  g.strokeStyle='#ffd454'; g.beginPath(); let started=false;
  for(const p of S.trail){const q=proj(p);
    if(!q){started=false;continue;}
    if(started) g.lineTo(q[0],q[1]); else {g.moveTo(q[0],q[1]); started=true;}}
  g.stroke();
  g.fillStyle='#ff6464';
  for(const k of S.kfs){const q=proj([k[1],k[2],k[3]]);
    if(q) g.fillRect(q[0]-2,q[1]-2,4,4);}
  g.strokeStyle='#50d070';
  for(const l of S.loops){
    const a=kfPos[l[0]], b=kfPos[l[1]]; if(!a||!b) continue;
    const qa=proj(a), qb=proj(b); if(!qa||!qb) continue;
    g.beginPath(); g.moveTo(qa[0],qa[1]); g.lineTo(qb[0],qb[1]); g.stroke();}
}
let dragging=false, lx=0, ly=0;
mapc.addEventListener('mousedown', e=>{dragging=true; lx=e.clientX; ly=e.clientY;});
window.addEventListener('mouseup', ()=>{dragging=false; saveCam();});
window.addEventListener('mousemove', e=>{
  if(!dragging) return;
  cam.t += (e.clientX-lx)*0.008; cam.p += (e.clientY-ly)*0.008;
  cam.p = Math.max(-1.57, Math.min(1.57, cam.p));
  lx=e.clientX; ly=e.clientY; saveCam(); draw3d();
});
mapc.addEventListener('wheel', e=>{
  e.preventDefault();
  cam.d *= (e.deltaY>0 ? 1.1 : 0.9); saveCam(); draw3d();
}, {passive:false});
mapc.addEventListener('dblclick', ()=>{cam=defaultCam(); saveCam(); draw3d();});
draw3d();

// ---- 2D scan pane (top-down x/z) --------------------------------------
function fit(pts){
  if(!pts.length) return [0,0,1];
  let xs=pts.map(p=>p[0]), zs=pts.map(p=>p[2]);
  let x0=Math.min(...xs), x1=Math.max(...xs);
  let z0=Math.min(...zs), z1=Math.max(...zs);
  return [(x0+x1)/2, (z0+z1)/2, Math.max(x1-x0, z1-z0, 1e-3)*1.15];
}
function draw(id, layers){
  const c=document.getElementById(id), g=c.getContext('2d');
  g.clearRect(0,0,c.width,c.height);
  let all=[].concat(...layers.map(l=>l.pts));
  const [cx,cz,s]=fit(all);
  const px=p=>[(p[0]-cx)/s*c.width + c.width/2,
               (p[2]-cz)/s*c.height*(-1) + c.height/2];
  for(const l of layers){
    g.fillStyle=l.color;
    for(const p of l.pts){const [x,y]=px(p);
      g.fillRect(x-l.r, y-l.r, 2*l.r, 2*l.r);}
  }
}
draw('scan', [
  {pts:S.scan_matched, color:'#e05050', r:1.5},
  {pts:S.scan_cur, color:'#50d070', r:1.5},
]);

// refresh without killing an in-progress drag
setInterval(()=>{ if(!dragging) location.reload(); }, 1000);
</script></body></html>
"""
