"""Web demo over the port's Pipeline and InferenceServer.

Counterpart of medseg_tpu/apps/demo.py (a behavioral twin of the reference
demo/app.py): classification/segmentation model dropdowns (defaults
ResNet18 / ResNetUnet), overlay-opacity slider, upload + Analyze/Clear
buttons, confidence CSS classes at the >90 / >70 thresholds, COVID-only
overlay visibility (app.py:138-162), and the full design.css stylesheet.
The gradio interface is built when gradio imports; otherwise `launch_demo`
serves the builtin page, the same surface over the stdlib HTTP server,
whose requests go through InferenceServer's micro-batched /predict.  The
event handlers are built by `make_handlers` against an injectable gradio
module, so the wiring is testable without gradio.  The models run on the
card unless device="cpu" is passed.
"""

from __future__ import annotations

from pathlib import Path

from medseg_tpu_torch.core.config import EvalConfig

# Verbatim copy of reference demo/design.css:1-101 (MIT; attribution header
# in the file), byte for byte the JAX package's apps/design.css.
CSS = (Path(__file__).with_name("design.css")).read_text()

CLS_CHOICES = ["ResNet18", "ResNet50", "VGG16", "VGG19", "CLIP"]
SEG_CHOICES = ["ResNetUnet", "AttentionUNet", "R2Unet", "R2AttUnet", "CLIPSeg"]

# Confidence CSS-class thresholds (reference demo/app.py:138-146).  Shared
# by the gradio handlers and the builtin page's generated JS so the two
# demo surfaces can't drift.
CONF_HIGH = 90
CONF_MED = 70


def make_handlers(processor, gr):
    """(handle, clear_all) event callbacks over an injectable `gr` module
    (anything exposing gr.update).  Mirrors reference demo/app.py:138-162:
    confidence classes at >90 / >70, overlay visible only for COVID."""

    def handle(image, cls_name, seg_name, op):
        processor._load_models(cls_name, seg_name)
        pred, conf, overlay, text = processor.process_image(image, seg_name,
                                                            overlay_opacity=op)
        conf_class = ("confidence-high" if conf > CONF_HIGH else
                      "confidence-medium" if conf > CONF_MED else
                      "confidence-low")
        is_covid = pred == "COVID" and overlay is not None
        return (pred,
                gr.update(value=f"Confidence: {conf:.2f}%",
                          elem_classes=[conf_class]),
                gr.update(value=overlay, visible=is_covid),
                gr.update(value=text, visible=True))

    def clear_all():
        return (None, None, gr.update(value=None, visible=False),
                gr.update(value="", visible=False))

    return handle, clear_all


def warmup_pipeline(processor, cls_name: str = "ResNet18",
                    seg_name: str = "ResNetUnet", log=print):
    """Load the default model pair and run both forwards once before
    serving (on the card: the photometric kernel's build and load, cuDNN's
    plans) — the single-image twin of InferenceServer.warmup (the gradio
    demo handles one upload at a time, so only the B=1 grid needs
    warming)."""
    import time

    import numpy as np

    t0 = time.time()
    processor._load_models(cls_name, seg_name)
    batch = np.zeros((1, 64, 64, 3), np.uint8)
    cls_size, cls_method = processor.input_grid(cls_name)
    seg_size, seg_method = processor.input_grid(seg_name)
    processor._predict_classification(
        processor._to_grid(batch, cls_size, processor.device, cls_method))
    processor._predict_segmentation(
        processor._to_grid(batch, seg_size, processor.device, seg_method))
    log(f"[demo] warmup ({cls_name}+{seg_name}) {time.time() - t0:.1f}s")


def create_interface(cfg: EvalConfig = EvalConfig(), *,
                     return_processor: bool = False, device=None):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; "
            "`pip install gradio` to run the demo") from e

    from medseg_tpu_torch.infer.pipeline import Pipeline

    processor = Pipeline(cfg, device=device)

    with gr.Blocks(css=CSS, theme=gr.themes.Soft(primary_hue="teal",
                                                 secondary_hue="blue")) as ui:
        with gr.Column(variant="compact"):
            gr.Markdown("# Lungs Radiography Analysis", elem_classes="heading")
            gr.Markdown("Upload/ Drop a chest X-ray image for COVID-19 "
                        "diagnosis and analysis.")
        with gr.Row(equal_height=True):
            with gr.Column(scale=1):
                cls_dd = gr.Dropdown(choices=CLS_CHOICES, value="ResNet18",
                                     label="Classification Model")
                seg_dd = gr.Dropdown(choices=SEG_CHOICES, value="ResNetUnet",
                                     label="Segmentation Model")
                opacity = gr.Slider(0.0, 1.0, step=0.05, value=0.5,
                                    label="Overlay Opacity (for COVID mask)",
                                    interactive=True)
            with gr.Column():
                input_image = gr.Image(label="Upload Chest X-ray", height=400,
                                       elem_classes="upload-image", type="pil")
                with gr.Row():
                    submit = gr.Button("Analyze Image", variant="primary",
                                       elem_classes="primary-button", scale=2)
                    clear = gr.Button("Clear", variant="secondary", scale=1)
            with gr.Column():
                with gr.Group(elem_classes="results-container"):
                    output_image = gr.Image(label="Infection Areas (COVID)",
                                            visible=False, height=400)
                with gr.Row(equal_height=True):
                    diagnosis = gr.Label(label="Diagnosis Conclusion",
                                         elem_classes="results-container")
                    confidence = gr.Label(label="Confidence Score",
                                          elem_classes="results-container")
                with gr.Row():
                    details = gr.Textbox(label="Diagnosis Details",
                                         visible=False, container=False, lines=5)
        with gr.Accordion("Information", open=False):
            gr.Markdown(
                "### Tutorial\n"
                "1. Upload or drag-and-drop a chest X-ray image.\n"
                "2. Select your trained Classification and Segmentation models.\n"
                "3. Choose 'Analyze Image'.\n"
                "4. For COVID cases, the segmentation mask is overlaid in red.")

        handle, clear_all = make_handlers(processor, gr)

        submit.click(handle, [input_image, cls_dd, seg_dd, opacity],
                     [diagnosis, confidence, output_image, details])
        clear.click(clear_all, [], [diagnosis, confidence, output_image, details])
    return (ui, processor) if return_processor else ui


def builtin_demo_page() -> str:
    """Dependency-free HTML twin of the gradio Blocks layout.

    Same surface as `create_interface` (and reference demo/app.py): model
    dropdowns, opacity slider, upload + Analyze/Clear, diagnosis +
    confidence labels with the design.css confidence classes at the
    CONF_HIGH/CONF_MED thresholds, COVID-only overlay, details box, and an
    Information accordion.  The page's JS posts to the InferenceServer's
    /predict (same JSON contract as any API client) so the demo rides the
    micro-batched serving path."""
    cls_opts = "".join(
        f'<option{" selected" if c == "ResNet18" else ""}>{c}</option>'
        for c in CLS_CHOICES)
    seg_opts = "".join(
        f'<option{" selected" if s == "ResNetUnet" else ""}>{s}</option>'
        for s in SEG_CHOICES)
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>Lungs Radiography Analysis</title>
<link rel="stylesheet" href="/design.css">
<style>
 body {{ font-family: sans-serif; margin: 0; background: #fafafa; }}
 .row {{ display: flex; gap: 16px; align-items: stretch; }}
 .col {{ flex: 1; display: flex; flex-direction: column; gap: 12px; }}
 label {{ font-size: 0.85em; color: #444; display: block; }}
 select, input[type=range] {{ width: 100%; }}
 .results-container {{ background: white; min-height: 2em; }}
 #overlay-box, #details {{ display: none; }}
 #overlay-box img, #preview {{ max-height: 400px; max-width: 100%; }}
 button.secondary {{ padding: 12px 24px; border-radius: 8px; }}
</style></head>
<body><div class="container">
 <h1 class="heading">Lungs Radiography Analysis</h1>
 <p>Upload/ Drop a chest X-ray image for COVID-19 diagnosis and analysis.</p>
 <div class="row">
  <div class="col">
   <label>Classification Model
    <select id="cls">{cls_opts}</select></label>
   <label>Segmentation Model
    <select id="seg">{seg_opts}</select></label>
   <label>Overlay Opacity (for COVID mask)
    <input type="range" id="opacity" min="0" max="1" step="0.05" value="0.5">
   </label>
  </div>
  <div class="col">
   <div data-testid="image" class="upload-image">
    <label>Upload Chest X-ray
     <input type="file" id="file" accept="image/*"></label>
    <img id="preview">
   </div>
   <div class="row image-controls">
    <button id="analyze" class="primary-button" style="flex:2">
     Analyze Image</button>
    <button id="clear" class="secondary" style="flex:1">Clear</button>
   </div>
  </div>
  <div class="col">
   <div id="overlay-box" class="results-container">
    <label>Infection Areas (COVID)</label><img id="overlay"></div>
   <div class="row">
    <div class="results-container" style="flex:1">
     <label>Diagnosis Conclusion</label><div id="diagnosis"></div></div>
    <div id="conf-box" class="results-container" style="flex:1">
     <label>Confidence Score</label><div id="confidence"></div></div>
   </div>
   <pre id="details" class="diagnosis-text"></pre>
  </div>
 </div>
 <details class="accordion"><summary>Information</summary>
  <h3>Tutorial</h3><ol>
   <li>Upload or drag-and-drop a chest X-ray image.</li>
   <li>Select your trained Classification and Segmentation models.</li>
   <li>Choose 'Analyze Image'.</li>
   <li>For COVID cases, the segmentation mask is overlaid in red.</li>
  </ol></details>
</div>
<script>
const $ = id => document.getElementById(id);
let b64 = null;
$("file").onchange = () => {{
  const f = $("file").files[0];
  if (!f) return;
  const r = new FileReader();
  r.onload = () => {{
    b64 = r.result.split(",")[1];
    $("preview").src = r.result;
  }};
  r.readAsDataURL(f);
}};
$("clear").onclick = () => {{
  b64 = null; $("preview").src = ""; $("file").value = "";
  $("diagnosis").textContent = ""; $("confidence").textContent = "";
  $("overlay-box").style.display = "none";
  $("details").style.display = "none";
  $("conf-box").className = "results-container";
}};
$("analyze").onclick = async () => {{
  if (!b64) {{ $("diagnosis").textContent = "Upload an image first"; return; }}
  $("diagnosis").textContent = "Analyzing...";
  const resp = await fetch("/predict", {{
    method: "POST", headers: {{"Content-Type": "application/json"}},
    body: JSON.stringify({{
      image: b64,
      classification_model: $("cls").value,
      segmentation_model: $("seg").value,
      overlay_opacity: parseFloat($("opacity").value),
    }})
  }});
  const out = await resp.json();
  if (!resp.ok) {{ $("diagnosis").textContent = "Error: " + out.error; return; }}
  $("diagnosis").textContent = out.prediction;
  $("confidence").textContent =
    "Confidence: " + out.confidence.toFixed(2) + "%";
  $("conf-box").className = "results-container " + (
    out.confidence > {CONF_HIGH} ? "confidence-high" :
    out.confidence > {CONF_MED} ? "confidence-medium" : "confidence-low");
  const covid = out.prediction === "COVID" && out.overlay;
  $("overlay-box").style.display = covid ? "block" : "none";
  if (covid) $("overlay").src = "data:image/png;base64," + out.overlay;
  $("details").textContent = out.analysis || "";
  $("details").style.display = out.analysis ? "block" : "none";
}};
</script></body></html>
"""


def attach_builtin_ui(server) -> None:
    """Mount the builtin demo page + stylesheet on an InferenceServer."""
    server.ui_routes["/"] = ("text/html; charset=utf-8",
                             builtin_demo_page().encode())
    server.ui_routes["/design.css"] = ("text/css", CSS.encode())


def launch_builtin_demo(cfg: EvalConfig = EvalConfig(),
                        host: str = "127.0.0.1", port: int = 7860,
                        warmup: bool = True, device=None):
    """Run the demo on the builtin (gradio-free) web UI."""
    from medseg_tpu_torch.infer.server import InferenceServer

    server = InferenceServer(cfg, device=device)
    attach_builtin_ui(server)
    if warmup:
        server.warmup()
    server.serve(host=host, port=port)


def launch_demo(share: bool = False, cfg: EvalConfig = EvalConfig(),
                host: str = "127.0.0.1", port: int = 7860,
                warmup: bool = True, device=None):
    """Gradio demo when gradio is installed; builtin web UI otherwise.

    host/port/warmup apply to both surfaces."""
    try:
        ui, processor = create_interface(cfg, return_processor=True, device=device)
    except RuntimeError as e:
        print(f"[demo] {e.__cause__ or e}; falling back to the builtin "
              "web UI (same surface, stdlib HTTP)")
        launch_builtin_demo(cfg, host=host, port=port, warmup=warmup, device=device)
        return
    if warmup:
        warmup_pipeline(processor)
    ui.launch(share=share, server_name=host, server_port=port)
