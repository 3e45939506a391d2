"""The built-in web UI: setup, join, cluster and chat pages (port of
``parallax_tpu/backend/webui.py``), on the port's standard-library HTTP
frontend.

``PAGE`` (``/ui``) and ``CHAT_PAGE`` (``/chat``) ship byte for byte as the
JAX package ships them, so they read the JAX frontend's fields:

- Setup: the model browser reads ``/ui/models`` and POSTs
  ``/scheduler/init``. Its estimate column reads the JAX catalog's
  ``min_chips_16g`` (chips of 16 GiB), which the port does not compute:
  the port's catalog sizes ``min_devices`` against the serving device's
  own memory instead, so that column is empty (ROADMAP queue 3,
  "Differences by design").
- Join: worker commands with their flags (they name the JAX CLI's module).
- Cluster: the pipelines from ``/cluster/status_json``, which a ``run``
  frontend serves (the scheduler's ``cluster_status()``) and a ``serve``
  frontend answers 501 until ROADMAP queue 1 item 9, as it does
  ``/metrics``.
- Chat: a streaming chat on ``/v1/chat/completions`` with cancel.
"""

from __future__ import annotations

import functools

# The estimate uses the scheduler's own capacity constants, so it cannot
# drift from what the allocator does.
from parallax_tpu_torch.scheduling.node import (
    HBM_UTILIZATION,
    KV_RESERVE_FRACTION,
)


@functools.lru_cache(maxsize=4)
def _model_catalog(device_bytes: int | None = None) -> tuple[dict, ...]:
    """Every ``MODEL_DB`` entry with serving-cost estimates from its config
    shapes: parameters, weight GiB, KV MiB per 1,024 tokens, and
    ``min_devices``, the fewest devices of ``device_bytes`` each whose
    weight share fits what the allocator gives weights (None when the
    device memory is not known)."""
    from parallax_tpu_torch.models.presets import MODEL_DB, get_preset

    out = []
    for name, entry in sorted(MODEL_DB.items()):
        try:
            cfg = get_preset(name)
        except Exception:  # an alias whose target cannot be served
            continue
        layer_params = sum(
            cfg.decoder_layer_params(i) for i in range(cfg.num_hidden_layers)
        )
        embed = cfg.embedding_params()
        total = layer_params + embed * (1 if cfg.tie_word_embeddings else 2)
        weight_bytes = total * cfg.param_bytes_per_element
        kv_mib_per_1k = (
            cfg.kv_bytes_per_token_per_layer() * cfg.num_hidden_layers
            * 1024 / 2**20
        )
        min_devices = None
        if device_bytes:
            per_device = int(device_bytes * HBM_UTILIZATION
                              * (1 - KV_RESERVE_FRACTION))
            min_devices = max(1, -(-int(weight_bytes) // per_device))
        out.append(dict(
            name=name,
            alias=bool(entry.get("alias") or entry.get("preset")),
            arch=cfg.architecture,
            layers=cfg.num_hidden_layers,
            params_b=round(total / 1e9, 2),
            weight_gib=round(weight_bytes / 2**30, 1),
            kv_mib_per_1k_tokens=round(kv_mib_per_1k, 1),
            min_devices=min_devices,
            moe=cfg.moe is not None,
            hybrid=cfg.linear_attn is not None,
            mla=cfg.is_mla,
        ))
    return tuple(out)


def ui_model_names(model_name: str) -> list[str]:
    """The served model first, then every preset and catalog name."""
    from parallax_tpu_torch.models.presets import MODEL_DB, PRESETS

    return [model_name] + sorted(
        set(list(PRESETS) + list(MODEL_DB)) - {model_name})


def register_ui(frontend, model_names: list[str],
                device_bytes: int | None = None) -> None:
    """Serve ``/ui``, ``/ui/meta``, ``/ui/models`` and ``/chat`` on
    ``frontend`` (an ``OpenAIFrontend``). ``device_bytes`` sizes the
    catalog's ``min_devices`` (the frontend's own device memory; None
    leaves it empty). ``/ui/meta`` names no scheduler address, as the JAX
    frontend's does not: the page falls back to its host's port 3002."""

    def ui(h) -> None:
        h.send_body(PAGE.encode(), "text/html; charset=utf-8")

    def chat(h) -> None:
        h.send_body(CHAT_PAGE.encode(), "text/html; charset=utf-8")

    def meta(h) -> None:
        h.send_json({"models": model_names, "scheduler_addr": ""})

    def models(h) -> None:
        h.send_json({"models": list(_model_catalog(device_bytes)),
                     "device_memory_bytes": device_bytes})

    frontend.add_route("GET", "/ui", ui)
    frontend.add_route("GET", "/ui/meta", meta)
    frontend.add_route("GET", "/ui/models", models)
    frontend.add_route("GET", "/chat", chat)


# r-string: the JS below ships byte for byte; every escape is written at
# the level the BROWSER should see (no Python string cooking).
PAGE = r"""<!doctype html><html><head><meta charset="utf-8">
<title>parallax-tpu</title><style>
:root{--bg:#0f1115;--panel:#171a21;--line:#2a2f3a;--fg:#e6e6e6;--dim:#9aa4b2;
--accent:#4f8ff7;--ok:#3fb950;--warn:#d29922;--err:#f85149}
*{box-sizing:border-box}body{margin:0;font-family:system-ui;background:var(--bg);
color:var(--fg);height:100vh;display:flex;flex-direction:column}
header{display:flex;align-items:center;gap:24px;padding:12px 20px;
border-bottom:1px solid var(--line);background:var(--panel)}
header h1{font-size:16px;margin:0}
nav button{background:none;border:none;color:var(--dim);font-size:14px;
padding:8px 12px;cursor:pointer;border-radius:6px}
nav button.active{color:var(--fg);background:#222838}
main{flex:1;overflow:auto;padding:20px;max-width:1000px;margin:0 auto;width:100%}
.card{background:var(--panel);border:1px solid var(--line);border-radius:10px;
padding:16px;margin-bottom:16px}
.card h2{margin:0 0 12px;font-size:14px;color:var(--dim);
text-transform:uppercase;letter-spacing:.06em}
select,input{background:#10131a;color:var(--fg);border:1px solid var(--line);
border-radius:6px;padding:8px 10px;font-size:14px}
button.primary{background:var(--accent);color:#fff;border:none;
border-radius:6px;padding:8px 16px;font-size:14px;cursor:pointer}
button.stop{background:var(--err);color:#fff;border:none;border-radius:6px;
padding:8px 16px;font-size:14px;cursor:pointer}
button.ghost{background:none;border:1px solid var(--line);color:var(--dim);
border-radius:6px;padding:4px 10px;font-size:12px;cursor:pointer}
code,pre{background:#10131a;border:1px solid var(--line);border-radius:6px;
padding:2px 6px;font-size:13px}
pre{padding:10px;overflow-x:auto;white-space:pre-wrap}
.node{display:inline-block;background:#10131a;border:1px solid var(--line);
border-radius:8px;padding:8px 12px;margin:4px;font-size:13px}
.node .id{color:var(--dim);font-size:11px}
.ok{color:var(--ok)}.warn{color:var(--warn)}
.pipeline{border-left:3px solid var(--accent);padding-left:10px;margin:10px 0}
#log{display:flex;flex-direction:column;gap:8px}
.msg{padding:10px 14px;border-radius:10px;white-space:pre-wrap;max-width:85%}
.user{background:#23406b;align-self:flex-end}.bot{background:#1c2129}
#chatbar{display:flex;gap:8px;margin-top:12px}
#chatbar input{flex:1}
.kv{display:grid;grid-template-columns:auto 1fr;gap:4px 16px;font-size:13px}
.kv .k{color:var(--dim)}
table{width:100%;border-collapse:collapse;font-size:13px}
th{color:var(--dim);text-align:left;font-weight:500;padding:6px 8px;
border-bottom:1px solid var(--line);cursor:pointer}
td{padding:6px 8px;border-bottom:1px solid #1c212b}
tr.row{cursor:pointer}tr.row:hover{background:#1a1f2a}
tr.sel{background:#20304d}
.tag{display:inline-block;font-size:10px;border:1px solid var(--line);
border-radius:4px;padding:0 4px;margin-left:4px;color:var(--dim)}
</style></head><body>
<header><h1>parallax-tpu</h1><nav>
<button data-tab="cluster" class="active">Cluster</button>
<button data-tab="chat">Chat</button>
<button data-tab="setup">Setup</button>
<button data-tab="join">Join</button>
</nav></header>
<main>
<section id="tab-cluster">
 <div class="card"><h2>Swarm status</h2><div id="status">loading…</div></div>
 <div class="card"><h2>Serving metrics</h2><pre id="metrics">…</pre></div>
</section>
<section id="tab-chat" hidden>
 <div class="card">
 <div style="display:flex;gap:8px;margin-bottom:8px;flex-wrap:wrap">
 <select id="chatmodel"></select>
 <input id="maxtok" type="number" value="512" min="1" style="width:90px"
  title="max tokens">
 <input id="ctemp" type="number" value="0.7" step="0.1" min="0"
  style="width:80px" title="temperature"></div>
 <div id="log"></div>
 <div id="chatbar"><input id="inp" placeholder="message…">
 <button class="primary" id="send">Send</button>
 <button class="stop" id="stop" hidden>Stop</button></div></div>
</section>
<section id="tab-setup" hidden>
 <div class="card"><h2>Model browser</h2>
 <input id="msearch" placeholder="filter models…" style="width:280px;
  margin-bottom:8px">
 <div style="max-height:380px;overflow:auto"><table id="mtable">
 <thead><tr><th data-k="name">model</th><th data-k="params_b">params B</th>
 <th data-k="weight_gib">weights GiB</th>
 <th data-k="kv_mib_per_1k_tokens">KV MiB/1k tok</th>
 <th data-k="min_chips_16g">~min 16G chips</th></tr></thead>
 <tbody></tbody></table></div></div>
 <div class="card"><h2>Start / switch model</h2>
 <p style="color:var(--dim);font-size:13px">Stops the current scheduler and
 bootstraps a fresh one; workers rejoin and reload on their next heartbeat.
 Workers must hold the model locally (checkpoint dir or preset).</p>
 <div style="display:flex;gap:8px;flex-wrap:wrap">
 <input id="model" style="min-width:320px" placeholder="model name">
 <input id="nnodes" type="number" min="1" value="1" style="width:90px"
  title="init nodes">
 <button class="primary" id="init">Initialize</button></div>
 <pre id="initout" hidden></pre></div>
</section>
<section id="tab-join" hidden>
 <div class="card"><h2>Scheduler-managed worker</h2>
 <p style="color:var(--dim);font-size:13px">Run on each worker host; the
 scheduler assigns its layer range (checkpoint must exist locally).</p>
 <pre id="joincmd">…</pre>
 <button class="ghost" data-copy="joincmd">copy</button></div>
 <div class="card"><h2>NAT'd worker (relay mode)</h2>
 <p style="color:var(--dim);font-size:13px">No inbound reachability: keeps a
 reverse connection at the scheduler; forwards ride the relay. Set the same
 --relay-token on the scheduler.</p>
 <pre id="joinrelay">…</pre>
 <button class="ghost" data-copy="joinrelay">copy</button></div>
 <div class="card"><h2>Scheduler-less gossip swarm</h2>
 <p style="color:var(--dim);font-size:13px">No scheduler anywhere: each
 worker pins its own layer range and gossips announcements; boundaries must
 meet exactly. Commands below mirror the LIVE pipeline layout (or an even
 split when none).</p>
 <pre id="joingossip">…</pre>
 <button class="ghost" data-copy="joingossip">copy</button></div>
 <div class="card"><h2>Optional flags</h2>
 <pre id="joinextras">--lora-adapters name=/peft/dir[,name=dir]   per-request adapters
--sp-size N --tp-size M                     chip mesh axes on this host
--quantization int8|int4                    on-load weight quantization
--refit-cache-dir DIR                       persist refit weight versions
--advertise-addr HOST                       externally reachable address</pre></div>
</section>
</main><script>
const $=s=>document.querySelector(s);
document.querySelectorAll('nav button').forEach(b=>b.onclick=()=>{
 document.querySelectorAll('nav button').forEach(x=>x.classList.remove('active'));
 b.classList.add('active');
 document.querySelectorAll('main section').forEach(s=>s.hidden=true);
 $('#tab-'+b.dataset.tab).hidden=false;
 if(b.dataset.tab==='chat')loadChatModels();
 if(b.dataset.tab==='setup')loadCatalog();
 if(b.dataset.tab==='join')renderJoin();});
let schedAddr='',lastStatus=null;
async function meta(){
 try{const m=await (await fetch('/ui/meta')).json();
  schedAddr=m.scheduler_addr||location.hostname+':3002';
  if(m.models&&m.models.length&&!$('#model').value)
   $('#model').value=m.models[0];
  renderJoin();
 }catch(e){}}
meta();
const BS=' \\\n  ';   // backslash + newline + indent for shell commands
function renderJoin(){
 // --model-path must be a LOCAL checkpoint directory on the worker
 // (cli join loads it at startup; names resolve only on live switches).
 const model=$('#model').value;
 const path='/path/to/checkpoint';
 const hint=model?'# checkpoint for: '+model+'\n':'';
 $('#joincmd').textContent=hint+'python -m parallax_tpu.cli join'+BS+
  '--scheduler-addr '+schedAddr+BS+'--model-path '+path+BS+'--port 0';
 $('#joinrelay').textContent=hint+'python -m parallax_tpu.cli join'+BS+
  '--scheduler-addr '+schedAddr+BS+'--model-path '+path+BS+
  '--relay --relay-token <swarm-secret>';
 let stages=null;
 if(lastStatus&&lastStatus.pipelines&&lastStatus.pipelines.length)
  stages=lastStatus.pipelines[0].nodes.map(n=>n.layers);
 if(!stages)stages=[[0,'L/2'],['L/2','L']];
 const peers=location.hostname+':<worker1-port>,'+location.hostname+
  ':<worker2-port>';
 $('#joingossip').textContent=hint+stages.map((se,i)=>
  '# stage '+i+' (layers ['+se[0]+', '+se[1]+'))\n'+
  'python -m parallax_tpu.cli join'+BS+'--peers '+peers+BS+
  '--model-path '+path+BS+'--start-layer '+se[0]+
  ' --end-layer '+se[1]).join('\n\n');
}
document.querySelectorAll('button.ghost[data-copy]').forEach(b=>
 b.onclick=()=>navigator.clipboard.writeText(
  $('#'+b.dataset.copy).textContent));
let catalog=[],sortKey='params_b',sortAsc=true,catLoaded=false;
async function loadCatalog(){
 if(catLoaded)return;catLoaded=true;
 try{const r=await fetch('/ui/models');catalog=(await r.json()).models;
  renderCatalog();}catch(e){catLoaded=false;}}
function renderCatalog(){
 const q=$('#msearch').value.toLowerCase();
 const rows=catalog.filter(m=>m.name.toLowerCase().includes(q))
  .sort((a,b)=>{const x=a[sortKey],y=b[sortKey];
   return (x<y?-1:x>y?1:0)*(sortAsc?1:-1);});
 $('#mtable tbody').innerHTML=rows.map(m=>
  '<tr class="row'+(m.name===$('#model').value?' sel':'')+
  '" data-name="'+m.name+'"><td>'+m.name+
  (m.moe?'<span class=tag>MoE</span>':'')+
  (m.hybrid?'<span class=tag>hybrid</span>':'')+
  (m.mla?'<span class=tag>MLA</span>':'')+
  (m.alias?'<span class=tag>alias</span>':'')+
  '</td><td>'+m.params_b+'</td><td>'+m.weight_gib+'</td><td>'+
  m.kv_mib_per_1k_tokens+'</td><td>'+m.min_chips_16g+'</td></tr>').join('');
 document.querySelectorAll('#mtable tr.row').forEach(tr=>tr.onclick=()=>{
  $('#model').value=tr.dataset.name;renderCatalog();renderJoin();});}
$('#msearch').oninput=renderCatalog;
document.querySelectorAll('#mtable th').forEach(th=>th.onclick=()=>{
 if(sortKey===th.dataset.k)sortAsc=!sortAsc;else{sortKey=th.dataset.k;
  sortAsc=th.dataset.k==='name';}renderCatalog();});
async function refresh(){
 try{
  const st=await (await fetch('/cluster/status_json')).json();
  lastStatus=st;
  let html='';
  if(st.pipelines){
   html+=`<div class="kv"><span class="k">bootstrapped</span><span>${st.bootstrapped?'<span class=ok>yes</span>':'<span class=warn>no</span>'}</span>`+
    `<span class="k">nodes</span><span>${st.num_active??''} active / ${st.num_standby??0} standby</span></div>`;
   for(const p of st.pipelines){
    html+=`<div class="pipeline"><b>pipeline ${p.id}</b><br>`+
     p.nodes.map(n=>`<span class="node">[${n.layers[0]}, ${n.layers[1]})`+
      ` ${n.ready?'<span class=ok>ready</span>':'<span class=warn>loading</span>'}`+
      ` load ${n.load}<br><span class="id">${n.node_id}</span></span>`).join('')+'</div>';}
  } else if(st.stages){
   html+='<div class="pipeline"><b>single host</b><br>'+st.stages.map(s=>
    `<span class="node">[${s.layers[0]}, ${s.layers[1]}) running ${s.running}`+
    ` waiting ${s.waiting}<br><span class="id">free pages ${s.free_pages}`+
    ` · cached ${s.cached_pages}</span></span>`).join('')+'</div>';
  } else html='<i>no status</i>';
  $('#status').innerHTML=html;
  $('#metrics').textContent=await (await fetch('/metrics')).text();
 }catch(e){$('#status').innerHTML='<i>status unavailable: '+e+'</i>';}
}
refresh();setInterval(refresh,3000);
const history=[];let busy=false,aborter=null;
function add(cls,text){const d=document.createElement('div');
 d.className='msg '+cls;d.textContent=text;$('#log').appendChild(d);
 d.scrollIntoView();return d;}
async function loadChatModels(){
 try{const r=await fetch('/v1/models');const j=await r.json();
  const sel=$('#chatmodel');const cur=sel.value;sel.innerHTML='';
  for(const m of j.data){const o=document.createElement('option');
   o.value=m.id;o.textContent=m.id;sel.appendChild(o);}
  if(cur)sel.value=cur;}catch(e){}}
loadChatModels();

async function send(){
 if(busy)return;const text=$('#inp').value.trim();if(!text)return;
 $('#inp').value='';busy=true;aborter=new AbortController();
 $('#stop').hidden=false;
 history.push({role:'user',content:text});add('user',text);
 const el=add('bot','');let acc='';
 try{
  const r=await fetch('/v1/chat/completions',{method:'POST',
   headers:{'Content-Type':'application/json'},signal:aborter.signal,
   body:JSON.stringify({model:$('#chatmodel').value||'parallax-tpu',
    messages:history,stream:true,
    max_tokens:parseInt($('#maxtok').value)||512,
    temperature:parseFloat($('#ctemp').value)||0})});
  if(!r.ok){el.textContent='[error '+r.status+']';history.pop();return;}
  const rd=r.body.getReader(),dec=new TextDecoder();let buf='';
  for(;;){const{done,value}=await rd.read();if(done)break;
   buf+=dec.decode(value,{stream:true});
   const lines=buf.split('\n');buf=lines.pop();
   for(const line of lines){if(!line.startsWith('data: '))continue;
    const d=line.slice(6);if(d==='[DONE]')continue;
    try{const c=JSON.parse(d).choices[0].delta?.content;
     if(c){acc+=c;el.textContent=acc;el.scrollIntoView();}}catch(e){}}}
  history.push({role:'assistant',content:acc});
 }catch(e){
  if(e.name==='AbortError'){
   // Keep what streamed; the server aborts the swarm-side request.
   el.textContent=acc+' [stopped]';
   if(acc)history.push({role:'assistant',content:acc});else history.pop();
  }else{el.textContent='[network error]';history.pop();}
 }
 finally{busy=false;aborter=null;$('#stop').hidden=true;$('#inp').focus();}}
$('#send').onclick=send;
$('#stop').onclick=()=>{if(aborter)aborter.abort();};
$('#inp').addEventListener('keydown',e=>{if(e.key==='Enter')send()});
$('#init').onclick=async()=>{
 const out=$('#initout');out.hidden=false;out.textContent='initializing…';
 try{
  const r=await fetch('/scheduler/init',{method:'POST',
   headers:{'Content-Type':'application/json'},
   body:JSON.stringify({model_name:$('#model').value,
    init_nodes_num:parseInt($('#nnodes').value)})});
  out.textContent=JSON.stringify(await r.json(),null,2);
 }catch(e){out.textContent='error: '+e;}};
</script></body></html>"""


# The minimal chat page (``/chat``), as the JAX frontend serves it.
CHAT_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>parallax-tpu chat</title><style>
body{font-family:system-ui;margin:0;display:flex;flex-direction:column;
height:100vh;background:#111;color:#eee}
#log{flex:1;overflow-y:auto;padding:16px;max-width:760px;margin:0 auto;width:100%}
.msg{margin:8px 0;padding:10px 14px;border-radius:10px;white-space:pre-wrap}
.user{background:#2a4365}.bot{background:#222}
#bar{display:flex;padding:12px;gap:8px;max-width:760px;margin:0 auto;width:100%}
#inp{flex:1;padding:10px;border-radius:8px;border:1px solid #444;
background:#1a1a1a;color:#eee}button{padding:10px 18px;border-radius:8px;
border:none;background:#3182ce;color:#fff;cursor:pointer}
</style></head><body><div id="log"></div><div id="bar">
<input id="inp" placeholder="message..." autofocus><button id="go">send</button>
</div><script>
const log=document.getElementById('log'),inp=document.getElementById('inp');
const btn=document.getElementById('go');
const history=[];let busy=false;
async function send(){
 if(busy)return;
 const text=inp.value.trim(); if(!text)return; inp.value='';
 busy=true;btn.disabled=true;
 history.push({role:'user',content:text});
 add('user',text); const el=add('bot','');
 try{
  const r=await fetch('/v1/chat/completions',{method:'POST',
   headers:{'Content-Type':'application/json'},
   body:JSON.stringify({model:'parallax-tpu',messages:history,
    stream:true,max_tokens:512})});
  if(!r.ok){const err=await r.text();
   el.textContent='[error '+r.status+': '+err.slice(0,200)+']';
   history.pop();return;}
  const rd=r.body.getReader(),dec=new TextDecoder();let acc='',buf='';
  for(;;){const{done,value}=await rd.read();if(done)break;
   buf+=dec.decode(value,{stream:true});
   const lines=buf.split('\\n');buf=lines.pop();
   for(const line of lines){if(!line.startsWith('data: '))continue;
    const d=line.slice(6);if(d==='[DONE]')continue;
    try{const c=JSON.parse(d).choices[0].delta?.content;
     if(c){acc+=c;el.textContent=acc;log.scrollTop=log.scrollHeight}}catch(e){}}}
  history.push({role:'assistant',content:acc});
 }catch(e){el.textContent='[network error: '+e+']';history.pop();}
 finally{busy=false;btn.disabled=false;inp.focus();}}
function add(cls,text){const d=document.createElement('div');
 d.className='msg '+cls;d.textContent=text;log.appendChild(d);
 log.scrollTop=log.scrollHeight;return d}
btn.onclick=send;
inp.addEventListener('keydown',e=>{if(e.key==='Enter')send()});
</script></body></html>"""
