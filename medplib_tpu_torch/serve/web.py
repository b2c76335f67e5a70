"""Built-in web UI (medplib_tpu/serve/web.py): browser chat with image
upload, region sketching and mask overlays, served by stdlib HTTP. The
browser talks to this server; the server resolves a worker through the
controller and proxies /generate to the worker's /worker_generate_stream
(urllib.request, no third-party HTTP client). Chat rounds and up / down
votes and flags go to a daily JSONL log.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_LOG_LOCK = threading.Lock()


def conv_log_filename(log_dir: str) -> str:
    """Daily conversation log file."""
    t = datetime.datetime.now()
    return os.path.join(log_dir,
                        f"{t.year}-{t.month:02d}-{t.day:02d}-conv.json")


def log_conv_event(log_dir: str, event_type: str, model: str, state,
                   ip: str) -> None:
    """Append one JSONL row: chat rounds and up/down-vote/flag events."""
    os.makedirs(log_dir, exist_ok=True)
    row = {"tstamp": round(time.time(), 4), "type": event_type,
           "model": model, "state": state, "ip": ip}
    with _LOG_LOCK, open(conv_log_filename(log_dir), "a") as f:
        f.write(json.dumps(row) + "\n")

PAGE = """<!doctype html>
<html><head><title>MedPLIB-TPU</title><style>
body{font-family:sans-serif;max-width:900px;margin:24px auto;padding:0 12px}
#wrap{display:flex;gap:16px}#left{flex:1}#right{flex:1}
canvas{border:1px solid #999;max-width:100%}
#log{white-space:pre-wrap;background:#f4f4f4;padding:8px;min-height:120px}
button{margin:4px 2px;padding:6px 12px}
</style></head><body>
<h2>MedPLIB-TPU — medical VQA, region VQA &amp; pixel grounding</h2>
<div id="wrap"><div id="left">
<input type="file" id="file" accept="image/*"><br>
<canvas id="cv" width="448" height="448"></canvas><br>
<button id="clear">clear region</button>
<span>draw on the image to mark a &lt;region&gt;</span></div>
<div id="right">
<textarea id="prompt" rows="3" style="width:100%"
 placeholder="Ask about the image... use <region></region> for the drawn region, ask to segment for a mask"></textarea>
<button id="send">send</button>
<button id="upvote">&#128077; upvote</button>
<button id="downvote">&#128078; downvote</button>
<button id="flag">&#9873; flag</button>
<div id="log"></div></div></div>
<script>
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
let img=null, drawing=false, regionMask=null, mctx=null;
function resetMask(){regionMask=document.createElement('canvas');
 regionMask.width=cv.width;regionMask.height=cv.height;
 mctx=regionMask.getContext('2d');}
resetMask();
document.getElementById('file').onchange=e=>{
 const f=e.target.files[0];if(!f)return;
 img=new Image();img.onload=()=>{cv.width=img.width;cv.height=img.height;
  resetMask();ctx.drawImage(img,0,0);};
 img.src=URL.createObjectURL(f);};
cv.onmousedown=()=>drawing=true;cv.onmouseup=()=>drawing=false;
cv.onmousemove=e=>{if(!drawing||!img)return;
 const r=cv.getBoundingClientRect();
 const x=(e.clientX-r.left)*cv.width/r.width,
       y=(e.clientY-r.top)*cv.height/r.height;
 ctx.fillStyle='rgba(0,120,255,0.4)';ctx.beginPath();
 ctx.arc(x,y,12,0,7);ctx.fill();
 mctx.fillStyle='#fff';mctx.beginPath();mctx.arc(x,y,12,0,7);mctx.fill();};
document.getElementById('clear').onclick=()=>{resetMask();
 if(img)ctx.drawImage(img,0,0);};
document.getElementById('send').onclick=async()=>{
 if(!img){alert('upload an image first');return;}
 const off=document.createElement('canvas');
 off.width=cv.width;off.height=cv.height;
 off.getContext('2d').drawImage(img,0,0);
 const imageB64=off.toDataURL('image/png').split(',')[1];
 const md=mctx.getImageData(0,0,cv.width,cv.height).data;
 const coords=[];
 for(let y=0;y<cv.height;y++)for(let x=0;x<cv.width;x++)
  if(md[(y*cv.width+x)*4+3]>0)coords.push([y,x]);
 const body={prompt:document.getElementById('prompt').value,
  images:[imageB64],
  region_masks:coords.length?[coords]:[],
  region_hw:[cv.height,cv.width]};
 document.getElementById('log').textContent='...';
 const resp=await fetch('/generate',{method:'POST',
  headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
 const raw=new Uint8Array(await resp.arrayBuffer());
 let text='',mask=null,h=0,w=0;
 let start=0;
 for(let i=0;i<raw.length;i++){if(raw[i]===0){
  const chunk=JSON.parse(new TextDecoder().decode(raw.slice(start,i)));
  text=chunk.text;
  if(chunk.mask&&chunk.mask.length){mask=chunk.mask;
   h=parseInt(chunk.height);w=parseInt(chunk.width);}
  start=i+1;}}
 document.getElementById('log').textContent=text;
 lastRound={prompt:body.prompt,text:text};
 if(mask){ctx.drawImage(img,0,0);
  ctx.fillStyle='rgba(255,0,0,0.45)';
  const sx=cv.width/w, sy=cv.height/h;
  for(const [y,x] of mask)ctx.fillRect(x*sx,y*sy,Math.ceil(sx),Math.ceil(sy));}
};
let lastRound=null;
async function vote(t){if(!lastRound)return;
 await fetch('/vote',{method:'POST',
  headers:{'Content-Type':'application/json'},
  body:JSON.stringify({type:t,state:lastRound})});}
document.getElementById('upvote').onclick=()=>vote('upvote');
document.getElementById('downvote').onclick=()=>vote('downvote');
document.getElementById('flag').onclick=()=>vote('flag');
</script></body></html>"""


def _post(url: str, payload: dict, timeout: float) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def make_handler(controller_url: str, model_name: str,
                 log_dir: str = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json_ok(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            # route FIRST: an unknown path must 404 without touching the
            # body, and a malformed body must 400 instead of a traceback
            if self.path not in ("/vote", "/generate"):
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n)) if n else {}
            except (ValueError, UnicodeDecodeError):
                self.send_response(400)
                self.end_headers()
                return
            if self.path == "/vote":
                # upvote/downvote/flag on the last response
                vt = payload.get("type", "")
                if vt not in ("upvote", "downvote", "flag"):
                    self.send_response(400)
                    self.end_headers()
                    return
                if log_dir:
                    log_conv_event(log_dir, vt, model_name,
                                   payload.get("state", {}),
                                   self.client_address[0])
                self._json_ok({"ok": True})
                return
            # resolve a worker
            addr = json.loads(_post(controller_url + "/get_worker_address",
                                    {"model": model_name}, 5))["address"]
            if not addr:
                self.send_response(503)
                self.end_headers()
                return
            content = _post(addr + "/worker_generate_stream", payload, 600)
            if log_dir:
                # last complete chunk carries the final text; a crashed
                # worker can emit a truncated part — logging is best-effort
                # and must never break proxying
                final = {}
                for part in content.split(b"\0"):
                    if part.strip():
                        try:
                            final = json.loads(part)
                        except (ValueError, UnicodeDecodeError):
                            continue
                log_conv_event(
                    log_dir, "chat", model_name,
                    {"prompt": payload.get("prompt", ""),
                     "text": final.get("text", ""),
                     "has_mask": bool(final.get("mask"))},
                    self.client_address[0])
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(content)))
            self.end_headers()
            self.wfile.write(content)

    return Handler


def serve(controller_url: str, model_name: str = "medplib-tpu",
          host: str = "0.0.0.0", port: int = 7860,
          log_dir: str = None) -> ThreadingHTTPServer:
    return ThreadingHTTPServer(
        (host, port), make_handler(controller_url, model_name, log_dir))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--controller-url", default="http://localhost:21001")
    ap.add_argument("--model", default="medplib-tpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--log-dir", default="serve_logs",
                    help="conversation/vote JSONL log dir (empty disables)")
    args = ap.parse_args()
    httpd = serve(args.controller_url, args.model, args.host, args.port,
                  log_dir=args.log_dir or None)
    print(f"web UI on http://{args.host}:{args.port}")
    httpd.serve_forever()
