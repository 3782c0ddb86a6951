"""Browser HTTP server (stdlib), on the port's read API: the ``view``
command.

``panagram_tpu.view.server`` over ``index.Table``s: the same page, routes
and answers.  Three tabs, click-through navigation (whole genome ->
chromosome -> region), drag-to-zoom and hover detail on the chromosome
view, a collapsible genome tree, a gene table with search, annotation-type
toggles, bookmarks, URL-addressable state, and a JSON / bitdump API.
Figures are rendered on the server with matplotlib (``plots``) and served
by ThreadingHTTPServer.  The data routes (/api/meta, /api/genes,
/api/bitdump) need no matplotlib; on a host without it a figure route
answers 500 with the ImportError that names it.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..index import Index, Table
from . import plots

_PAGE = """<!DOCTYPE html>
<html><head><title>panagram_tpu</title><style>
body{font-family:sans-serif;margin:0;background:#f4f5f7}
header{background:#1f3044;color:#fff;padding:10px 16px;font-size:18px}
nav button{margin:8px 4px;padding:6px 14px;border:1px solid #1f3044;
  background:#fff;cursor:pointer;border-radius:4px}
nav button.active{background:#1f3044;color:#fff}
.tab{display:none;padding:12px 16px}
.tab.active{display:block}
img{max-width:100%;background:#fff;border:1px solid #ddd;margin:6px 0}
select,input{margin:2px;padding:3px}
.ctl{background:#fff;padding:8px;border:1px solid #ddd;border-radius:4px}
.imgwrap{position:relative;display:inline-block}
#selbox{position:absolute;border:1px solid #d03a3a;
  background:rgba(208,58,58,.15);pointer-events:none;display:none}
#tip{position:fixed;background:#1f3044;color:#fff;padding:4px 8px;
  font-size:11px;border-radius:3px;pointer-events:none;display:none;
  z-index:9;max-width:340px}
table.genes{border-collapse:collapse;background:#fff;font-size:12px;
  margin-top:6px}
table.genes th,table.genes td{border:1px solid #ddd;padding:3px 8px}
table.genes tr:hover{background:#eef3fa;cursor:pointer}
#tree svg{background:#fff;border:1px solid #ddd}
.treelabel{font-size:10px}
.treenode{cursor:pointer}
#annotypes label{margin-right:10px;font-size:12px}
</style></head><body>
<header>panagram_tpu &mdash; pan-genome k-mer browser</header>
<nav>
 <button id="b0" onclick="tab(0)" class="active">Pangenome</button>
 <button id="b1" onclick="tab(1)">Anchor genome</button>
 <button id="b2" onclick="tab(2)">Chromosome</button>
</nav>
<div id="t0" class="tab active">
 <img src="/plot/pangenome/composition.png">
 <img src="/plot/pangenome/dendrogram.png">
 <img src="/plot/pangenome/sizes.png">
 <img src="/plot/pangenome/chr_hist.png">
</div>
<div id="t1" class="tab">
 <div class="ctl">Anchor genome:
  <select id="genome" onchange="refreshAnchor()"></select>
  <span style="color:#666;font-size:12px">click a chromosome band to open
  it in the Chromosome tab</span></div>
 <div class="imgwrap"><img id="wg" onclick="wgClick(event)"></div>
 <img id="umap">
 <img id="genec">
</div>
<div id="t2" class="tab">
 <div class="ctl">
  Genome <select id="cgenome" onchange="chromList()"></select>
  Chromosome <select id="chrom" onchange="setRegion(null,null)"></select>
  <input id="start" size="10" placeholder="start">
  <input id="end" size="10" placeholder="end">
  <button onclick="go()">Go</button>
  <button onclick="zoom(0.5)">Zoom in</button>
  <button onclick="zoom(2)">Zoom out</button>
  <button onclick="pan(-0.5)">&laquo; Pan</button>
  <button onclick="pan(0.5)">Pan &raquo;</button>
  <select id="bookmarks" onchange="jumpBookmark()" style="display:none">
  </select>
  <div id="annotypes"></div>
 </div>
 <div class="imgwrap"><img id="chrwhole"
   onmousedown="dragStart(event,'chrwhole')"></div>
 <div class="imgwrap"><img id="chrview"
   onmousedown="dragStart(event,'chrview')"
   onmousemove="hover(event)" onmouseleave="tipHide()"></div>
 <div id="selbox"></div>
 <div style="display:flex;gap:16px;align-items:flex-start">
  <div>
   <h4 style="margin:4px 0">Genome tree
    <span style="color:#666;font-weight:normal;font-size:11px">
    (click a node to collapse/expand heatmap rows)</span></h4>
   <div id="tree"></div>
  </div>
  <div>
   <h4 style="margin:4px 0">Genes
    <input id="genesearch" placeholder="search name..."
     oninput="geneTable()"></h4>
   <div id="genetable"></div>
  </div>
 </div>
 <img id="chrumap">
</div>
<div id="tip"></div>
<script>
let META=null, VIEWMAP=null, WGMAP=null, CWMAP=null;
let COLLAPSE=[], TYPES=null;   // null = all annotation types on
function $(id){return document.getElementById(id);}
function tab(i){for(let j=0;j<3;j++){
  $('t'+j).classList.toggle('active',i==j);
  $('b'+j).classList.toggle('active',i==j);}
  saveHash();}
function curTab(){for(let j=0;j<3;j++)
  if($('t'+j).classList.contains('active'))return j; return 0;}

// ---- URL-addressable state: #tab.genome.chrom:start-end.types.collapse
function saveHash(){
  const p=new URLSearchParams();
  p.set('tab',curTab());
  p.set('genome',$('cgenome').value||'');
  p.set('chrom',$('chrom').value||'');
  p.set('start',$('start').value);p.set('end',$('end').value);
  if(TYPES!==null)p.set('types',TYPES.join(','));
  if(COLLAPSE.length)p.set('collapse',COLLAPSE.join(','));
  history.replaceState(null,'','#'+p.toString());
}
function loadHash(){
  if(!location.hash)return null;
  return new URLSearchParams(location.hash.slice(1));
}

async function init(){
  META=await (await fetch('/api/meta')).json();
  for(const sel of ['genome','cgenome']){
    const s=$(sel);
    for(const g of META.anchors){const o=document.createElement('option');
      o.value=o.text=g;s.add(o);}
  }
  if(META.init.genome){$('genome').value=META.init.genome;
    $('cgenome').value=META.init.genome;}
  if(META.bookmarks.length){const s=$('bookmarks');
    s.style.display='';
    const o=document.createElement('option');o.text='bookmarks...';s.add(o);
    for(const b of META.bookmarks){const o=document.createElement('option');
      o.value=JSON.stringify(b);o.text=b.name||(b.chrom+':'+b.start+'-'+b.end);
      s.add(o);}}
  const h=loadHash();
  if(h&&h.get('genome')){
    $('genome').value=h.get('genome');$('cgenome').value=h.get('genome');
    if(h.get('types'))TYPES=h.get('types').split(',').filter(x=>x);
    if(h.get('collapse'))
      COLLAPSE=h.get('collapse').split(',').filter(x=>x).map(Number);
    refreshAnchor();chromList(h.get('chrom'));
    setRegion(h.get('start')||null,h.get('end')||null);
    tab(parseInt(h.get('tab')||'0'));
    return;
  }
  refreshAnchor(); chromList();
  if(META.init.chrom){$('chrom').value=META.init.chrom;
    setRegion(META.init.start,META.init.end); tab(2);}
}
async function refreshAnchor(){
  const g=$('genome').value;
  $('wg').src='/plot/anchor/'+g+'/whole.png';
  $('umap').src='/plot/anchor/'+g+'/umap.png';
  $('genec').src='/plot/anchor/'+g+'/genes.png';
  WGMAP=await (await fetch('/api/map/anchor/'+g)).json();
}
function chromList(selectChrom){
  const g=$('cgenome').value;
  const s=$('chrom');s.innerHTML='';
  for(const c of META.chrs[g]){const o=document.createElement('option');
    o.value=o.text=c;s.add(o);}
  if(selectChrom)s.value=selectChrom;
  else setRegion(null,null);
}
function region(){
  const size=META.sizes[$('cgenome').value][$('chrom').value];
  let st=parseInt($('start').value);
  let en=parseInt($('end').value);
  if(isNaN(st)||st<0)st=0; if(isNaN(en)||en>size||en<=st)en=size;
  return [st,en,size];
}
function setRegion(st,en){
  $('start').value=st==null?'':st;
  $('end').value=en==null?'':en;
  go();
}
function viewQuery(){
  const [st,en,_]=region();
  let q='start='+st+'&end='+en;
  if(TYPES!==null)q+='&types='+encodeURIComponent(TYPES.join(','));
  if(COLLAPSE.length)q+='&collapse='+COLLAPSE.join(',');
  return q;
}
async function go(){
  const g=$('cgenome').value;
  const c=$('chrom').value;
  if(!c)return;
  const [st,en,_]=region();
  const q=viewQuery();
  $('chrwhole').src='/plot/chrom/'+g+'/'+c+'/whole.png?start='+st+'&end='+en;
  $('chrview').src='/plot/chrom/'+g+'/'+c+'/view.png?'+q;
  $('chrumap').src='/plot/chrom/'+g+'/'+c+'/umap.png';
  saveHash();
  const r=await fetch('/api/view/'+g+'/'+c+'?'+q);
  VIEWMAP=await r.json();
  CWMAP=await (await fetch('/api/map/chrom/'+g+'/'+c
    +'?start='+st+'&end='+en)).json();
  drawTree(); annoTypeBoxes(); geneTable();
}
function zoom(f){const [st,en,size]=region();const c=(st+en)/2,h=(en-st)*f/2;
  setRegion(Math.max(0,Math.round(c-h)),Math.min(size,Math.round(c+h)));}
function pan(f){const [st,en,size]=region();let d=Math.round((en-st)*f);
  if(st+d<0)d=-st; if(en+d>size)d=size-en;
  setRegion(st+d,en+d);}
function jumpBookmark(){const v=$('bookmarks').value;
  try{const b=JSON.parse(v);$('chrom').value=b.chrom;
    setRegion(b.start,b.end);}catch(e){}}

// ---- pixel <-> coordinate helpers ------------------------------------
function imgXY(ev,img){
  const r=img.getBoundingClientRect();
  const sx=img.naturalWidth/r.width, sy=img.naturalHeight/r.height;
  return [(ev.clientX-r.left)*sx,(ev.clientY-r.top)*sy];
}
function rowAt(map,x,y){
  if(!map)return null;
  for(const row of map.rows)
    if(x>=row.px0&&x<=row.px1&&y>=row.py0&&y<=row.py1)return row;
  return null;
}
function pxToBp(row,x){
  const f=(x-row.px0)/(row.px1-row.px0);
  return Math.round(row.bp0+f*(row.bp1-row.bp0));
}

// ---- whole-genome plot click-through ---------------------------------
function wgClick(ev){
  const [x,y]=imgXY(ev,$('wg'));
  const row=rowAt(WGMAP,x,y);
  if(!row)return;
  const bp=pxToBp(row,x);
  if(bp>row.size)return;
  $('cgenome').value=$('genome').value;
  chromList(row.chrom);
  const w=Math.max(Math.round(row.size/20),1000);
  setRegion(Math.max(0,bp-w),Math.min(row.size,bp+w));
  tab(2);
}

// ---- drag-to-zoom on the chromosome plots ----------------------------
let DRAG=null;
function dragStart(ev,imgid){
  ev.preventDefault();
  DRAG={img:imgid,x0:ev.clientX,y0:ev.clientY,moved:false};
  document.onmousemove=dragMove;document.onmouseup=dragEnd;
}
function dragMove(ev){
  if(!DRAG)return;
  DRAG.moved=Math.abs(ev.clientX-DRAG.x0)>4;
  const b=$('selbox');
  b.style.display='block';
  b.style.left=Math.min(DRAG.x0,ev.clientX)+window.scrollX+'px';
  b.style.top=DRAG.y0+window.scrollY-10+'px';
  b.style.width=Math.abs(ev.clientX-DRAG.x0)+'px';
  b.style.height='20px';
}
function dragEnd(ev){
  document.onmousemove=null;document.onmouseup=null;
  $('selbox').style.display='none';
  if(!DRAG)return;
  const img=$(DRAG.img);
  const map=DRAG.img=='chrwhole'?CWMAP:VIEWMAP;
  const fake={clientX:DRAG.x0,clientY:DRAG.y0};
  const [xa,ya]=imgXY(fake,img);
  const [xb,yb]=imgXY(ev,img);
  const row=rowAt(map,xa,ya)||rowAt(map,xb,yb);
  DRAG=null;
  if(!row||!map)return;
  if((window.DRAGMOVED=Math.abs(xb-xa))>6){  // drag: zoom to selection
    let b1=pxToBp(row,Math.min(xa,xb)),b2=pxToBp(row,Math.max(xa,xb));
    setRegion(Math.max(0,b1),Math.min(map.size||row.size,b2));
  }else{                                      // click: recenter
    const bp=pxToBp(row,xa);
    const [st,en,size]=region();
    const h=Math.max(Math.round((en-st)/2),500);
    setRegion(Math.max(0,bp-h),Math.min(size,bp+h));
  }
}

// ---- hover detail ----------------------------------------------------
// index-derived strings (chromosome/genome names, tree labels) must never
// be parsed as markup: tip lines join with <br> but each line is escaped
function esc(s){const d=document.createElement('div');
  d.textContent=String(s);return d.innerHTML;}
function tipShow(ev,html){const t=$('tip');t.innerHTML=html;
  t.style.display='block';
  t.style.left=(ev.clientX+14)+'px';t.style.top=(ev.clientY+14)+'px';}
function tipHide(){$('tip').style.display='none';}
function hover(ev){
  if(!VIEWMAP||DRAG)return tipHide();
  const [x,y]=imgXY(ev,$('chrview'));
  const row=rowAt(VIEWMAP,x,y);
  if(!row)return tipHide();
  const bp=pxToBp(row,x);
  let html=esc($('chrom').value)+':'+bp.toLocaleString();
  const bx=VIEWMAP.bins_x;
  if(bx&&bx.length){
    let i=bx.findIndex(v=>v>bp);i=(i<0?bx.length:i)-1;
    if(i>=0&&VIEWMAP.mean_occ[i]!==undefined)
      html+='<br>bin mean occupancy: '+VIEWMAP.mean_occ[i];
  }
  if(row.panel=='heatmap'&&VIEWMAP.labels){
    const fr=(y-row.py0)/(row.py1-row.py0);
    const gi=Math.floor(fr*VIEWMAP.labels.length);
    if(gi>=0&&gi<VIEWMAP.labels.length)
      html+='<br>genome: '+esc(VIEWMAP.labels[gi]);
  }
  tipShow(ev,html);
}

// ---- annotation-type toggles -----------------------------------------
function annoTypeBoxes(){
  const div=$('annotypes');div.innerHTML='';
  if(!VIEWMAP||!VIEWMAP.anno_types||!VIEWMAP.anno_types.length)return;
  div.appendChild(document.createTextNode('annotation tracks: '));
  for(const t of VIEWMAP.anno_types){
    const lab=document.createElement('label');
    const cb=document.createElement('input');cb.type='checkbox';
    cb.checked=TYPES===null||TYPES.includes(t);
    cb.onchange=()=>{
      const on=[...div.querySelectorAll('input')].filter(c=>c.checked)
        .map(c=>c.parentNode.textContent.trim());
      TYPES=on.length==VIEWMAP.anno_types.length?null:on;
      go();
    };
    lab.appendChild(cb);lab.appendChild(document.createTextNode(t));
    div.appendChild(lab);
  }
}

// ---- collapsible genome tree -----------------------------------------
function drawTree(){
  const div=$('tree');div.innerHTML='';
  if(!VIEWMAP||!VIEWMAP.tree)return;
  const leaves=[];
  function countLeaves(nd){
    if(!nd.children||COLLAPSE.includes(nd.id)){leaves.push(nd);return;}
    nd.children.forEach(countLeaves);
  }
  countLeaves(VIEWMAP.tree);
  const H=Math.max(leaves.length*16,40), W=260;
  const maxd=VIEWMAP.tree.dist||1;
  const svgns='http://www.w3.org/2000/svg';
  const svg=document.createElementNS(svgns,'svg');
  svg.setAttribute('width',W);svg.setAttribute('height',H+10);
  let yi=0;
  function layout(nd){
    const x=nd.dist?(1-nd.dist/maxd)*(W-110):W-110;
    if(!nd.children||COLLAPSE.includes(nd.id)){
      const y=12+16*yi++;
      drawNode(nd,W-105,y,true);
      return [W-110,y];
    }
    const pts=nd.children.map(layout);
    const y=(pts[0][1]+pts[pts.length-1][1])/2;
    for(const [cx,cy] of pts){
      line(x,cy,cx,cy);line(x,pts[0][1],x,pts[pts.length-1][1]);
    }
    drawNode(nd,x,y,false);
    return [x,y];
  }
  function line(x1,y1,x2,y2){
    const l=document.createElementNS(svgns,'line');
    l.setAttribute('x1',x1);l.setAttribute('y1',y1);
    l.setAttribute('x2',x2);l.setAttribute('y2',y2);
    l.setAttribute('stroke','#888');svg.appendChild(l);
  }
  function drawNode(nd,x,y,isLeaf){
    const g=document.createElementNS(svgns,'g');
    g.setAttribute('class','treenode');
    const c=document.createElementNS(svgns,'circle');
    c.setAttribute('cx',x);c.setAttribute('cy',y);c.setAttribute('r',4);
    c.setAttribute('fill',COLLAPSE.includes(nd.id)?'#d03a3a':
      (isLeaf?'#2a6099':'#888'));
    g.appendChild(c);
    const t=document.createElementNS(svgns,'text');
    t.setAttribute('x',x+7);t.setAttribute('y',y+4);
    t.setAttribute('class','treelabel');
    t.textContent=nd.name||('['+nd.size+' genomes]');
    g.appendChild(t);
    if(nd.children||COLLAPSE.includes(nd.id))
      g.onclick=()=>{
        const i=COLLAPSE.indexOf(nd.id);
        if(i>=0)COLLAPSE.splice(i,1);else COLLAPSE.push(nd.id);
        go();
      };
    svg.appendChild(g);
  }
  layout(VIEWMAP.tree);
  div.appendChild(svg);
}

// ---- gene table ------------------------------------------------------
async function geneTable(){
  const g=$('cgenome').value, c=$('chrom').value;
  if(!c)return;
  const [st,en,_]=region();
  const q=$('genesearch').value;
  const r=await fetch('/api/genes?genome='+g+'&chrom='+c+'&start='+st
    +'&end='+en+(q?'&q='+encodeURIComponent(q):''));
  const genes=await r.json();
  const div=$('genetable');
  div.textContent='';
  if(!genes.length){const i=document.createElement('i');
    i.style.fontSize='12px';i.textContent='no genes in view';
    div.appendChild(i);return;}
  // DOM construction, not innerHTML: gene names come verbatim from the
  // user's GFF and must never be parsed as markup
  const tbl=document.createElement('table');tbl.className='genes';
  const hr=tbl.insertRow();
  for(const h of ['name','start','end','unique','universal']){
    const th=document.createElement('th');th.textContent=h;
    hr.appendChild(th);}
  for(const gn of genes.slice(0,200)){
    const tr=tbl.insertRow();
    tr.onclick=((s,e)=>()=>setRegion(s,e))(gn.start,gn.end);
    for(const v of [gn.name,gn.start.toLocaleString(),
                    gn.end.toLocaleString(),gn.unique,gn.universal])
      tr.insertCell().textContent=v;}
  div.appendChild(tbl);
  if(genes.length>200){const i=document.createElement('i');
    i.style.fontSize='11px';i.textContent=(genes.length-200)+' more...';
    div.appendChild(i);}
}
init();
</script></body></html>
"""


def bitmap_tsv(t: Table) -> str:
    """A query_bitmap table as ``DataFrame.to_csv(sep="\\t")`` writes it:
    a header of an empty cell and the genome names, then one line per row,
    its position and its 0/1 bits."""
    lines = ["\t" + "\t".join(str(c) for c in t.columns)]
    lines += [f"{p}\t" + "\t".join(map(str, r))
              for p, r in zip(t.index, t.values.tolist())]
    return "\n".join(lines) + "\n"


def _contains(name, pattern: str) -> bool:
    """pandas' ``str.contains(pattern, case=False, regex=False)``."""
    return pattern.upper() in str(name).upper()


class _Handler(BaseHTTPRequestHandler):
    index: Index = None
    params = None
    # bounded LRU, so that a long-lived server does not keep every
    # rendered PNG; reset by serve(), so that a new or rebuilt index never
    # serves stale plots
    _cache = OrderedDict()
    _cache_max = 128
    _lock = threading.Lock()          # cache bookkeeping
    _render_lock = threading.Lock()   # matplotlib is not thread-safe

    def log_message(self, fmt, *args):
        pass

    def _send(self, body, ctype="text/html"):
        if isinstance(body, str):
            body = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, msg, code=500):
        body = msg.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        # keep_blank_values: an empty 'types=' means "no annotation
        # tracks", which must stay distinct from no parameter ("all")
        q = {k: v[0]
             for k, v in parse_qs(url.query, keep_blank_values=True).items()}
        parts = [p for p in url.path.split("/") if p]
        try:
            self._route(url.path, parts, q)
        except BrokenPipeError:
            pass
        except (KeyError, IndexError):
            # usually a malformed or unknown plot or api path; a genuine
            # render bug lands here too, so the diagnostic stays on the
            # server's side while the client gets a 404
            print(f"404 {self.path}\n{traceback.format_exc()}", flush=True)
            self._error("not found", 404)
        except Exception:
            self._error(traceback.format_exc())

    def _cached(self, key, build):
        """Cache (png, map) pairs under one key.  Builds serialize under
        _render_lock (pyplot's global figure registry is not thread-safe,
        and the client asks for a png and its map twin together, under one
        key); the re-check inside the lock stops a key being rendered
        twice."""
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        with self._render_lock:
            with self._lock:
                if key in self._cache:
                    self._cache.move_to_end(key)
                    return self._cache[key]
            t0 = time.perf_counter()
            val = build()
            print(f"render {key[-1] if isinstance(key, tuple) else key}: "
                  f"{1e3 * (time.perf_counter() - t0):.0f} ms "
                  f"{key}", flush=True)
        with self._lock:
            self._cache[key] = val
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_max:
                self._cache.popitem(last=False)
        return val

    # ---- chromosome view: one cached render serves png + map ----
    def _view_pair(self, genome, chrom, q):
        idx = self.index
        start = int(q["start"]) if q.get("start") else None
        end = int(q["end"]) if q.get("end") else None
        types = None
        if "types" in q:
            types = set(t for t in q["types"].split(",") if t)
        collapse = None
        if q.get("collapse"):
            collapse = set(int(v) for v in q["collapse"].split(",") if v)
        key = (genome, chrom, start, end, q.get("types"), q.get("collapse"),
               "view")
        return self._cached(key, lambda: plots.chromosome_view(
            idx, genome, chrom, start, end,
            self.params.get("max_chr_bins", 350),
            order_names=self.params.get("order"),
            types=types, collapse=collapse,
        ))

    def _chr_whole_pair(self, genome, chrom, q):
        idx = self.index
        start = int(q["start"]) if q.get("start") else None
        end = int(q["end"]) if q.get("end") else None
        key = (genome, chrom, start, end, "chr_whole")
        return self._cached(key, lambda: plots.chr_whole_plot(
            idx, genome, chrom, start, end))

    def _meta(self) -> dict:
        idx = self.index
        loaded = [g for g in idx.anchor_genomes
                  if idx.genomes[g].chrs is not None]
        return {
            "genomes": list(idx.genome_names),
            "anchors": loaded,
            "chrs": {g: [c[0] for c in idx.genomes[g].chrs] for g in loaded},
            "sizes": {g: {c: int(s) for c, s in idx.genomes[g].sizes.items()}
                      for g in loaded},
            "ngenomes": idx.ngenomes,
            "init": self.params.get("init", {}),
            "bookmarks": self.params.get("bookmarks", []),
        }

    def _genes(self, q) -> list:
        g = self.index.genomes[q["genome"]]
        start = int(q["start"]) if q.get("start") else None
        end = int(q["end"]) if q.get("end") else None
        t = g.query_genes(q.get("chrom"), start, end)
        col = {c: i for i, c in enumerate(t.columns)}
        n = self.index.ngenomes
        rows = t.values
        if q.get("q"):
            rows = [r for r in rows if _contains(r[col["name"]], q["q"])]
        return [{"chrom": r[col["chr"]], "start": int(r[col["start"]]),
                 "end": int(r[col["end"]]), "name": str(r[col["name"]]),
                 "unique": int(r[col[1]] if 1 in col else 0),
                 "universal": int(r[col[n]] if n in col else 0)}
                for r in rows]

    def _route(self, path, parts, q):
        idx = self.index
        if not parts:
            return self._send(_PAGE)

        if parts[0] == "api":
            if parts[1] == "meta":
                return self._send(json.dumps(self._meta()),
                                  "application/json")
            if parts[1] == "bitdump":
                t = idx.query_bitmap(
                    q["genome"], q["chrom"], int(q.get("start", 0)),
                    int(q["end"]), int(q.get("step", 1)),
                )
                return self._send(bitmap_tsv(t), "text/plain")
            if parts[1] == "genes":
                return self._send(json.dumps(self._genes(q)),
                                  "application/json")
            if parts[1] == "map" and parts[2] == "anchor":
                genome = parts[3]
                _, m = self._cached(
                    (genome, "wg"),
                    lambda: plots.whole_genome_plot(
                        idx, genome, self.params.get("max_chr_bins", 350)))
                return self._send(json.dumps(m), "application/json")
            if parts[1] == "map" and parts[2] == "chrom":
                _, m = self._chr_whole_pair(parts[3], parts[4], q)
                return self._send(json.dumps(m), "application/json")
            if parts[1] == "view":
                _, m = self._view_pair(parts[2], parts[3], q)
                return self._send(json.dumps(m), "application/json")

        if parts[0] == "plot":
            png = None
            if parts[1] == "pangenome":
                figures = {
                    "composition.png": lambda: plots.pangenome_composition(idx),
                    "dendrogram.png": lambda: plots.genome_dendrogram(idx),
                    "sizes.png": lambda: plots.genome_sizes_plot(idx),
                    "chr_hist.png": lambda: plots.chromosome_histograms(idx),
                }
                png = self._cached(parts[2], figures[parts[2]])
            elif parts[1] == "anchor":
                genome, what = parts[2], parts[3]
                if what == "whole.png":
                    png, _ = self._cached(
                        (genome, "wg"),
                        lambda: plots.whole_genome_plot(
                            idx, genome,
                            self.params.get("max_chr_bins", 350)))
                else:
                    figures = {
                        "umap.png": lambda: plots.umap_scatter(idx, genome),
                        "genes.png": lambda: plots.gene_content_plot(
                            idx, genome),
                    }
                    png = self._cached(f"{genome}/{what}", figures[what])
            elif parts[1] == "chrom":
                genome, chrom, what = parts[2], parts[3], parts[4]
                if what == "whole.png":
                    png, _ = self._chr_whole_pair(genome, chrom, q)
                elif what == "umap.png":
                    png = self._cached(
                        f"{genome}/{chrom}/umap",
                        lambda: plots.umap_scatter(idx, genome, chrom),
                    )
                else:
                    png, _ = self._view_pair(genome, chrom, q)
            if png is not None:
                return self._send(png, "image/png")

        self._error("not found", 404)


def _load_bookmarks(path):
    if not path:
        return []
    out = []
    with open(path) as f:
        for line in f:
            p = line.split("\t")
            if len(p) >= 3:
                out.append({
                    "chrom": p[0], "start": int(p[1]), "end": int(p[2]),
                    "name": p[3].strip() if len(p) > 3 else None,
                })
    return out


def serve(args):
    index = Index(args.index_dir)
    _Handler.index = index
    _Handler._cache = OrderedDict()
    _Handler.params = {
        "max_chr_bins": getattr(args, "max_chr_bins", 350),
        "order": getattr(args, "order", None),
        "init": {
            "genome": getattr(args, "genome", None),
            "chrom": getattr(args, "chrom", None),
            "start": getattr(args, "start", None),
            "end": getattr(args, "end", None),
        },
        "bookmarks": _load_bookmarks(getattr(args, "bookmarks", None)),
    }
    host = getattr(args, "host", "127.0.0.1")
    port = int(getattr(args, "port", 8050))
    httpd = ThreadingHTTPServer((host, port), _Handler)
    print(f"panagram_tpu_torch view serving http://{host}:{port}/")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        index.close()
