"""First-party web UI: the search page (``GET /``) and the manage page
(``GET /manage``).

A copy of ``imatch_tpu/serving/ui.py``, byte for byte in the pages it
serves: two dependency-free static pages of vanilla JS against the same
REST contract (three-mode search with weight slider and limit select,
filter checkboxes, single and batch upload with 409-aware statuses,
filter management with progress polling, metadata editing, reset).
"""

from __future__ import annotations

_STYLE = """
:root{color-scheme:dark}
*{box-sizing:border-box;margin:0}
body{font:15px/1.5 system-ui,sans-serif;background:#0e1116;color:#e6e8eb;padding:0 0 4rem}
header{display:flex;gap:1.5rem;align-items:baseline;padding:1rem 2rem;border-bottom:1px solid #232833}
header h1{font-size:1.2rem}
header a{color:#7aa2f7;text-decoration:none;font-size:.95rem}
main{max-width:1100px;margin:1.5rem auto;padding:0 2rem}
fieldset{border:1px solid #232833;border-radius:8px;padding:1rem;margin-bottom:1rem}
legend{padding:0 .5rem;color:#9aa4b2}
label{display:block;margin:.4rem 0 .15rem;color:#9aa4b2;font-size:.85rem}
input[type=text],textarea,select{width:100%;padding:.45rem .6rem;border:1px solid #2c3442;border-radius:6px;background:#151a22;color:#e6e8eb}
input[type=file]{color:#9aa4b2}
button{padding:.5rem 1rem;border:0;border-radius:6px;background:#3b82f6;color:#fff;cursor:pointer;margin:.5rem .4rem 0 0}
button.danger{background:#b91c1c}
button:disabled{opacity:.5;cursor:wait}
.grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(180px,1fr));gap:1rem;margin-top:1.5rem}
.card{background:#151a22;border:1px solid #232833;border-radius:8px;overflow:hidden;cursor:pointer}
.card img{width:100%;height:140px;object-fit:cover;display:block;background:#0a0d12}
.card .m{padding:.5rem .6rem;font-size:.82rem;color:#9aa4b2}
.score{color:#34d399}
.row{display:flex;gap:1rem;flex-wrap:wrap}
.row>div{flex:1;min-width:240px}
#status,.status{margin:.8rem 0;color:#fbbf24;white-space:pre-wrap;font-size:.88rem}
.chip{display:inline-flex;gap:.35rem;align-items:center;background:#1d2430;border:1px solid #2c3442;border-radius:999px;padding:.2rem .7rem;margin:.2rem .3rem 0 0;font-size:.85rem}
.chip button{margin:0;padding:0 .3rem;background:transparent;color:#f87171}
dialog{background:#151a22;color:#e6e8eb;border:1px solid #2c3442;border-radius:10px;max-width:640px;width:90%}
dialog::backdrop{background:rgba(0,0,0,.6)}
progress{width:100%}
.dropzone{border:2px dashed #2c3442;border-radius:8px;padding:1.4rem;text-align:center;color:#9aa4b2;cursor:pointer;margin:.3rem 0 .6rem}
.dropzone.drag{border-color:#3b82f6;background:#101826;color:#e6e8eb}
"""

_SEARCH_JS = """
const $=s=>document.querySelector(s);
const esc=s=>String(s??'').replace(/[&<>"']/g,c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
let filters=[];
async function loadFilters(){
  const r=await fetch('/api/filters'); const j=await r.json();
  const box=$('#filters'); box.innerHTML='';
  (j.filters||[]).forEach((f,i)=>{
    const id='f_'+i;  // btoa throws on non-Latin-1 filter text
    box.insertAdjacentHTML('beforeend',
      `<span class="chip"><input type="checkbox" id="${id}" value="${esc(f)}"><label for="${id}">${esc(f)}</label></span>`);
  });
}
function selectedFilters(){
  return [...document.querySelectorAll('#filters input:checked')].map(e=>e.value);
}
function updateMode(){
  const hasImg=$('#qimg').files.length>0, hasTxt=$('#qtext').value.trim().length>0;
  $('#weightwrap').style.display=(hasImg&&hasTxt)?'block':'none';
}
async function doSearch(ev){
  ev.preventDefault();
  const hasImg=$('#qimg').files.length>0, hasTxt=$('#qtext').value.trim().length>0;
  if(!hasImg&&!hasTxt&&selectedFilters().length===0){
    $('#status').textContent='enter a text query, pick an image, or select filters';
    return;
  }
  const fd=new FormData(); const limit=$('#limit').value;
  fd.append('limit',limit);
  selectedFilters().forEach(f=>fd.append('filters',f));
  let url;
  if(hasImg&&hasTxt){url='/api/search/multimodal';fd.append('file',$('#qimg').files[0]);
    fd.append('query',$('#qtext').value);fd.append('weight_image',$('#weight').value);}
  else if(hasImg){url='/api/search/image';fd.append('file',$('#qimg').files[0]);}
  else{url='/api/search/text';fd.append('query',$('#qtext').value);}
  $('#go').disabled=true;$('#status').textContent='searching…';
  try{
    const r=await fetch(url,{method:'POST',body:fd}); const j=await r.json();
    if(!r.ok){$('#status').textContent='error: '+(j.error||r.status);render([]);}
    else{render(j.results||[]);
      $('#status').textContent=`${(j.results||[]).length} results`;}
  }catch(e){$('#status').textContent='error: '+e}
  $('#go').disabled=false;
}
function render(rs){
  const g=$('#results'); g.innerHTML='';
  rs.forEach(r=>{
    const pct=r.similarity_score!=null?(100*r.similarity_score).toFixed(1)+'%':'';
    g.insertAdjacentHTML('beforeend',`<div class="card" onclick='detail(${JSON.stringify(esc(r.id))})'>
      <img src="${esc(r.thumbnail_url||r.url)}" loading="lazy">
      <div class="m"><span class="score">${pct}</span> ${esc(r.description||r.filename||r.id)}</div></div>`);
  });
}
async function detail(id){
  const r=await fetch('/api/image/'+id); if(!r.ok)return;
  const m=(await r.json()).image;
  $('#dbody').innerHTML=`<img src="${esc(m.url)}" style="max-width:100%;border-radius:6px">
    <p><b>${esc(m.filename||'')}</b></p><p>${esc(m.description||'')}</p>
    <p style="white-space:pre-wrap;color:#9aa4b2">${esc(m.custom_metadata||'')}</p>
    <p style="color:#6b7280;font-size:.8rem">${esc(m.id)} · ${esc(m.created_at||'')}</p>`;
  $('#dlg').showModal();
}
window.addEventListener('DOMContentLoaded',()=>{
  loadFilters();
  $('#qimg').addEventListener('change',updateMode);
  $('#qtext').addEventListener('input',updateMode);
  $('#sform').addEventListener('submit',doSearch);
});
"""

SEARCH_HTML = f"""<!doctype html><html><head><meta charset="utf-8">
<title>ImageMatch — Search</title><style>{_STYLE}</style>
<script>{_SEARCH_JS}</script></head><body>
<header><h1>ImageMatch</h1><a href="/">Search</a><a href="/manage">Manage</a></header>
<main>
<form id="sform">
<fieldset><legend>Search</legend>
<div class="row">
<div><label>Text query</label><input type="text" id="qtext" placeholder="red drill…"></div>
<div><label>Image query</label><input type="file" id="qimg" accept="image/*"></div>
</div>
<div id="weightwrap" style="display:none">
<label>Image weight: <output id="wout">0.5</output></label>
<input type="range" id="weight" min="0" max="1" step="0.05" value="0.5"
  oninput="document.getElementById('wout').textContent=this.value">
</div>
<div class="row">
<div><label>Limit</label><select id="limit">
<option>10</option><option>25</option><option>50</option><option>100</option>
<option value="0">All</option></select></div>
<div><label>Filters (AND)</label><span id="filters"></span></div>
</div>
<button id="go">Search</button>
</fieldset>
</form>
<div id="status"></div>
<div class="grid" id="results"></div>
<dialog id="dlg"><div id="dbody"></div>
<form method="dialog"><button>Close</button></form></dialog>
</main></body></html>"""

_MANAGE_JS = """
const $=s=>document.querySelector(s);
const esc=s=>String(s??'').replace(/[&<>"']/g,c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
// client-side size cap, matching the reference FileDropzone
// (frontend/src/components/FileDropzone.tsx:17-24, maxSize 10 MB)
const MAX_FILE_MB=10;
function checkSizes(files){
  const ok=[],rejected=[];
  [...files].forEach(f=>(f.size<=MAX_FILE_MB*1024*1024?ok:rejected).push(f));
  return {ok,rejected};
}
function sizeMsg(rejected){
  return rejected.length?`rejected (> ${MAX_FILE_MB} MB): `+
    rejected.map(f=>f.name).join(', ')+'\\n':'';
}
async function upload(ev){
  ev.preventDefault();
  const f=$('#ufile').files[0];
  if(f&&f.size>MAX_FILE_MB*1024*1024){
    $('#ustatus').textContent=`file exceeds ${MAX_FILE_MB} MB`;return;}
  const fd=new FormData();
  fd.append('file',f);
  fd.append('description',$('#udesc').value);
  fd.append('custom_metadata',$('#umeta').value);
  fd.append('remove_bg',$('#ubg').checked);
  $('#ustatus').textContent='uploading…';
  try{
    const r=await fetch('/api/upload',{method:'POST',body:fd});
    const j=await r.json();
    $('#ustatus').textContent=r.status===409?'duplicate — already indexed ('+j.metadata.id+')'
      :(j.success?'indexed as '+j.metadata.id:'error: '+(j.error||r.status));
  }catch(e){$('#ustatus').textContent='error: '+e;}
  listImages();
}
// Sequential per-file upload with live progress and 409 classification —
// the uploadFolderWithProgress capability (frontend/src/lib/api.ts:125-238),
// including its 1 Hz filter-activity poll while each file processes.
async function uploadSequential(files,removeBg){
  const total=files.length; let ok=0,skip=0,fail=0; const lines=[];
  const bar=$('#bprogbar'); $('#bprog').style.display='block'; bar.max=total;
  let pollTimer=null;
  const cleanup=()=>{if(pollTimer){clearInterval(pollTimer);pollTimer=null;}};
  for(let i=0;i<total;i++){
    const f=files[i]; bar.value=i;
    $('#bstatus').textContent=`Uploading file ${i+1} of ${total}: ${f.name}\\n`+lines.join('\\n');
    let fi=0;
    cleanup();
    pollTimer=setInterval(async()=>{
      try{const j=await (await fetch('/api/filters')).json();
        const n=(j.filters||[]).length;
        if(n>0){fi=Math.min(fi+1,n);
          $('#bstatus').textContent=
            `Processing ${i+1}/${total}: applying filters (${fi}/${n})\\n`+lines.join('\\n');}
      }catch(e){}
    },1000);
    try{
      const fd=new FormData();
      fd.append('file',f); fd.append('remove_bg',removeBg);
      const r=await fetch('/api/upload',{method:'POST',body:fd});
      const j=await r.json();
      if(r.status===409||(j.error||'').includes('Duplicate')){
        skip++;lines.push(`${f.name}: skipped — ${j.message||'duplicate'}`);
      }else if(j.success){ok++;lines.push(`${f.name}: success (${j.metadata.id})`);}
      else{fail++;lines.push(`${f.name}: error — ${j.error||r.status}`);}
    }catch(e){fail++;lines.push(`${f.name}: error — ${e}`);}
    finally{cleanup();}
  }
  bar.value=total;
  $('#bstatus').textContent=`done: ${ok} ok, ${skip} skipped, ${fail} failed\\n`+lines.join('\\n');
}
async function uploadBatch(ev){
  ev.preventDefault();
  const {ok,rejected}=checkSizes($('#bfiles').files);
  if(!ok.length){$('#bstatus').textContent=sizeMsg(rejected)||'no files';return;}
  if($('#bseq').checked){
    await uploadSequential(ok,$('#bbg').checked);
    $('#bstatus').textContent=sizeMsg(rejected)+$('#bstatus').textContent;
    listImages();return;
  }
  const fd=new FormData();
  ok.forEach(f=>fd.append('files',f));
  fd.append('remove_bg',$('#bbg').checked);
  $('#bstatus').textContent=sizeMsg(rejected)+'uploading '+ok.length+' files…';
  try{
    const r=await fetch('/api/upload-folder',{method:'POST',body:fd});
    const j=await r.json();
    if(!r.ok){$('#bstatus').textContent=sizeMsg(rejected)+'error: '+(j.error||r.status);}
    else{$('#bstatus').textContent=sizeMsg(rejected)+
      `done: ${j.successful} ok, ${j.skipped} skipped, ${j.failed} failed\\n`+
      (j.results||[]).map(x=>`${x.filename}: ${x.status}${x.reason?' — '+x.reason:''}`).join('\\n');}
  }catch(e){$('#bstatus').textContent=sizeMsg(rejected)+'error: '+e;}
  listImages();
}
// drag-and-drop zone (FileDropzone.tsx equivalent)
function wireDropzone(){
  const dz=$('#dropzone'), input=$('#bfiles');
  const stop=e=>{e.preventDefault();e.stopPropagation();};
  ['dragenter','dragover'].forEach(t=>dz.addEventListener(t,e=>{stop(e);dz.classList.add('drag');}));
  ['dragleave','drop'].forEach(t=>dz.addEventListener(t,e=>{stop(e);dz.classList.remove('drag');}));
  dz.addEventListener('drop',e=>{
    const dt=new DataTransfer();
    [...input.files].forEach(f=>dt.items.add(f));
    [...e.dataTransfer.files].forEach(f=>{if(f.type.startsWith('image/'))dt.items.add(f);});
    input.files=dt.files;
    dz.querySelector('span').textContent=dt.files.length+' file(s) selected';
  });
  dz.addEventListener('click',()=>input.click());
  input.addEventListener('change',()=>{
    dz.querySelector('span').textContent=input.files.length+' file(s) selected';});
}
async function loadFilters(){
  const r=await fetch('/api/filters');const j=await r.json();
  const box=$('#flist');box.innerHTML='';
  // DOM construction, not inline-onclick HTML: injection-safe for ANY
  // filter text, no escape gymnastics (the old string-built handler
  // emitted an invalid unicode escape and killed the whole page script)
  (j.filters||[]).forEach(f=>{
    const chip=document.createElement('span');chip.className='chip';
    chip.appendChild(document.createTextNode(f));
    const b=document.createElement('button');b.textContent='✕';
    b.addEventListener('click',()=>delFilter(f));
    chip.appendChild(b);box.appendChild(chip);
  });
}
async function delFilter(f){
  try{await fetch('/api/filters/'+encodeURIComponent(f),{method:'DELETE'});}
  catch(e){$('#fprogtext').textContent='delete failed: '+e;$('#fprog').style.display='block';}
  loadFilters();
}
async function addFilter(ev){
  ev.preventDefault();
  const q=$('#fquery').value.trim(); if(!q)return;
  // comma-separated batch add (legacy app.py:2489-2515 capability)
  const parts=q.split(',').map(s=>s.trim()).filter(Boolean);
  const fd=new FormData();
  let url='/api/filters';
  if(parts.length>1){url='/api/filters/batch';fd.append('filter_queries',q);}
  else fd.append('filter_query',q);
  try{await fetch(url,{method:'POST',body:fd});}
  catch(e){$('#fprogtext').textContent='add failed: '+e;$('#fprog').style.display='block';return;}
  $('#fquery').value=''; loadFilters();
  parts.forEach(p=>pollProgress(p));
}
// One poller at a time: the progress text/bar are shared elements, so
// comma-batch adds queue their filters and poll SEQUENTIALLY instead of
// interleaving writes (the bar used to flip between filters every tick).
const _pollQueue=[]; let _polling=false;
function pollProgress(q){
  _pollQueue.push(q);
  if(!_polling)_pollNext();
}
function _pollNext(){
  const q=_pollQueue.shift();
  if(q===undefined){_polling=false;return;}
  _polling=true;
  const el=$('#fprog'); el.style.display='block';
  let notFound=0, errors=0;
  const tick=async()=>{
    let j;
    try{
      const r=await fetch('/api/filter-progress?filter_query='+encodeURIComponent(q));
      j=await r.json();
    }catch(e){
      // transient blip must not freeze the bar forever
      if(errors++<20){setTimeout(tick,1000);}
      else{$('#fprogtext').textContent=`${q}: poll failed — ${e}`;_pollNext();}
      return;
    }
    $('#fprogtext').textContent=`${q}: ${j.status} ${j.progress||0}% `+
      (j.current_image?('— '+j.current_image):'')+
      (j.errors?` (${j.errors} errors)`:'');
    $('#fprogbar').value=j.progress||0;
    // 'not_found' right after add is the registration race (the
    // backfill thread hasn't written its progress record yet) — keep
    // polling briefly instead of freezing the bar forever
    if(j.status==='processing'||j.status==='pending'){setTimeout(tick,500);}
    else if(j.status==='not_found'&&notFound++<20){setTimeout(tick,500);}
    else{_pollNext();}
  };
  tick();
}
async function listImages(){
  const r=await fetch('/api/images');const j=await r.json();
  const g=$('#imgs');g.innerHTML='';
  (j.images||[]).forEach(m=>{
    g.insertAdjacentHTML('beforeend',`<div class="card" onclick='edit(${JSON.stringify(esc(m.id))})'>
      <img src="${esc(m.thumbnail_url||m.url)}" loading="lazy">
      <div class="m">${esc(m.description||m.filename||m.id)}</div></div>`);
  });
  $('#count').textContent=(j.images||[]).length+' images';
}
let editing=null;
async function edit(id){
  const r=await fetch('/api/image/'+id);if(!r.ok)return;
  const m=(await r.json()).image; editing=id;
  $('#edesc').value=m.description||''; $('#emeta').value=m.custom_metadata||'';
  $('#eimg').src=m.url; $('#eid').textContent=id;
  $('#edlg').showModal();
}
async function saveEdit(ev){
  ev.preventDefault();
  const fd=new FormData();
  fd.append('description',$('#edesc').value);
  fd.append('custom_metadata',$('#emeta').value);
  try{
    const r=await fetch('/api/metadata/'+editing,{method:'PUT',body:fd});
    if(!r.ok){const j=await r.json();alert('save failed: '+(j.error||r.status));return;}
  }catch(e){alert('save failed: '+e);return;}
  $('#edlg').close(); listImages();
}
async function resetAll(){
  if(!confirm('Delete ALL images, embeddings and filters?'))return;
  if(!confirm('This cannot be undone. Really reset?'))return;
  await fetch('/api/reset',{method:'POST'});
  listImages(); loadFilters();
}
window.addEventListener('DOMContentLoaded',()=>{
  $('#uform').addEventListener('submit',upload);
  $('#bform').addEventListener('submit',uploadBatch);
  $('#fform').addEventListener('submit',addFilter);
  $('#eform').addEventListener('submit',saveEdit);
  wireDropzone();
  loadFilters(); listImages();
});
"""

MANAGE_HTML = f"""<!doctype html><html><head><meta charset="utf-8">
<title>ImageMatch — Manage</title><style>{_STYLE}</style>
<script>{_MANAGE_JS}</script></head><body>
<header><h1>ImageMatch</h1><a href="/">Search</a><a href="/manage">Manage</a></header>
<main>
<form id="uform"><fieldset><legend>Upload image</legend>
<label>File</label><input type="file" id="ufile" accept="image/*" required>
<label>Description</label><input type="text" id="udesc">
<label>Custom metadata</label><textarea id="umeta" rows="2"></textarea>
<label><input type="checkbox" id="ubg"> remove background</label>
<button>Upload</button><div class="status" id="ustatus"></div>
</fieldset></form>

<form id="bform"><fieldset><legend>Batch upload</legend>
<div id="dropzone" class="dropzone"><span>Drop images here or click to browse
(max 10 MB each)</span></div>
<input type="file" id="bfiles" multiple accept="image/*" style="display:none">
<label><input type="checkbox" id="bbg"> remove background</label>
<label><input type="checkbox" id="bseq"> per-file progress (sequential
uploads; the default one-request batch uses the fused device path)</label>
<button>Upload all</button>
<div id="bprog" style="display:none"><progress id="bprogbar" max="1" value="0"></progress></div>
<div class="status" id="bstatus"></div>
</fieldset></form>

<form id="fform"><fieldset><legend>Filters</legend>
<label>New yes/no filter (comma-separate for batch)</label>
<input type="text" id="fquery" placeholder="is there a person, is it outdoors">
<button>Add</button>
<div id="fprog" style="display:none"><progress id="fprogbar" max="100" value="0"></progress>
<div class="status" id="fprogtext"></div></div>
<div id="flist"></div>
</fieldset></form>

<fieldset><legend>Library <span id="count"></span></legend>
<div class="grid" id="imgs"></div></fieldset>

<fieldset style="border-color:#7f1d1d"><legend style="color:#f87171">Danger zone</legend>
<button class="danger" onclick="resetAll()">Reset system</button>
</fieldset>

<dialog id="edlg"><form id="eform">
<img id="eimg" style="max-width:100%;border-radius:6px">
<p id="eid" style="color:#6b7280;font-size:.8rem"></p>
<label>Description</label><input type="text" id="edesc">
<label>Custom metadata</label><textarea id="emeta" rows="3"></textarea>
<button>Save</button><button type="button" onclick="document.getElementById('edlg').close()">Cancel</button>
</form></dialog>
</main></body></html>"""


def register_ui(app) -> None:
    from imatch_tpu_torch.serving.asgi import HTMLResponse

    @app.get("/")
    def index(req):
        return HTMLResponse(SEARCH_HTML)

    @app.get("/manage")
    def manage(req):
        return HTMLResponse(MANAGE_HTML)
