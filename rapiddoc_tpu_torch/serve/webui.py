"""Browser demo UI for the parse service.

Role parity with the reference Gradio webui (reference:
rapid_doc/cli/gradio_app.py:186-232, 483-537 — upload a document, pick
parse options, preview rendered markdown, download results as zip).
Gradio is not available in this environment, so this is a dependency-free
single page (vanilla JS, no CDN assets) served by the HTTP service; the
markdown preview is rendered server-side with the package's own
md->HTML converter (utils/markdown_convert). Copy of the JAX package's
module: the same page, byte for byte.
"""
from __future__ import annotations

PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>rapiddoc-tpu</title>
<style>
 :root { color-scheme: light dark; }
 body { font: 15px/1.5 system-ui, sans-serif; margin: 0; display: flex;
        height: 100vh; }
 aside { width: 280px; padding: 18px; border-right: 1px solid #8884;
         display: flex; flex-direction: column; gap: 12px; }
 main { flex: 1; overflow: auto; padding: 24px 32px; }
 h1 { font-size: 18px; margin: 0 0 6px; }
 label { display: block; font-size: 13px; opacity: .8; }
 select, input[type=file], button { width: 100%; padding: 6px;
         margin-top: 2px; }
 button { cursor: pointer; font-weight: 600; }
 .row { display: flex; gap: 8px; align-items: center; }
 .row input { width: auto; }
 #status { font-size: 13px; min-height: 1.2em; }
 #preview table, #preview td, #preview th { border: 1px solid #8886;
         border-collapse: collapse; padding: 3px 7px; }
 #preview img { max-width: 100%; }
 #mdsrc { width: 100%; height: 70vh; display: none; }
 nav button { width: auto; padding: 4px 14px; }
</style>
</head>
<body>
<aside>
  <h1>rapiddoc-tpu</h1>
  <input type="file" id="file">
  <label>Parse method
    <select id="method"><option>auto</option><option>txt</option>
      <option>ocr</option></select></label>
  <label>Language
    <select id="lang"><option>ch</option><option>en</option></select></label>
  <div class="row"><input type="checkbox" id="formula" checked>
    <label for="formula">Formula recognition</label></div>
  <div class="row"><input type="checkbox" id="table" checked>
    <label for="table">Table recognition</label></div>
  <button id="go">Parse</button>
  <button id="zip" disabled>Download zip</button>
  <div id="status"></div>
</aside>
<main>
  <nav><button id="tab-preview">Preview</button>
       <button id="tab-md">Markdown</button></nav>
  <div id="preview"></div>
  <textarea id="mdsrc" readonly></textarea>
</main>
<script>
const $ = id => document.getElementById(id);
let lastForm = null;
function form() {
  const f = new FormData();
  f.append('file', $('file').files[0]);
  f.append('parse_method', $('method').value);
  f.append('lang', $('lang').value);
  f.append('formula_enable', $('formula').checked);
  f.append('table_enable', $('table').checked);
  return f;
}
$('go').onclick = async () => {
  if (!$('file').files.length) { $('status').textContent = 'pick a file'; return; }
  $('status').textContent = 'parsing…';
  $('go').disabled = true;
  try {
    const r = await fetch('webui_parse', {method: 'POST', body: form()});
    const j = await r.json();
    if (!r.ok) throw new Error(j.error || r.statusText);
    $('preview').innerHTML = j.html;
    $('mdsrc').value = j.markdown;
    $('zip').disabled = false;
    lastForm = form();
    $('status').textContent = 'done (' + j.markdown.length + ' chars)';
  } catch (e) { $('status').textContent = 'error: ' + e.message; }
  $('go').disabled = false;
};
$('zip').onclick = async () => {
  const f = form(); f.append('return_format', 'zip');
  const r = await fetch('file_parse', {method: 'POST', body: f});
  const blob = await r.blob();
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob);
  a.download = ($('file').files[0].name.replace(/\\.[^.]+$/, '') || 'result') + '.zip';
  a.click();
};
$('tab-preview').onclick = () => { $('preview').style.display = 'block';
  $('mdsrc').style.display = 'none'; };
$('tab-md').onclick = () => { $('preview').style.display = 'none';
  $('mdsrc').style.display = 'block'; };
</script>
</body>
</html>
"""


def render_preview_html(markdown: str, images: dict[str, bytes]) -> str:
    """Markdown -> preview HTML with images inlined as data URIs."""
    import base64

    from ..utils.markdown_convert import markdown_to_html

    html = markdown_to_html(markdown, full_page=False)
    for rel, blob in images.items():
        suffix = rel.rsplit(".", 1)[-1].lower()
        mime = {"jpg": "jpeg", "jpeg": "jpeg"}.get(suffix, suffix or "png")
        uri = f"data:image/{mime};base64,{base64.b64encode(blob).decode()}"
        html = html.replace(f'src="{rel}"', f'src="{uri}"')
    return html
