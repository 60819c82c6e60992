"""Edit-quality report of two frame directories, the port's twin of
``scripts/compare_outputs.py`` (same JSON keys and rounding):

    python -m tokenflow_torch.cli.compare_outputs DIR_A DIR_B [--out report.json]
        [--clip_ckpt CLIP_DIR_OR_FILE --prompt "..."] [--device cuda|cpu]

- per-frame PSNR of DIR_A against DIR_B (``psnr_per_frame``, ``psnr_mean``,
  ``psnr_min``), over the first min(len) frames of each, sorted by name;
- with ``--clip_ckpt`` (an HF ``CLIPModel``: a directory with its weights,
  and optionally ``config.json`` and the tokenizer's ``vocab.json`` /
  ``merges.txt``, or one weight file): the mean cosine of consecutive DIR_A
  frames' CLIP image embeddings (``clip_temporal_consistency``) and, with a
  tokenizer and ``--prompt``, the CLIP score of DIR_A's frames against the
  prompt (``clip_score_mean``, ``clip_score_min``).

The geometry comes from the checkpoint's ``config.json`` when it has one,
else openai/clip-vit-large-patch14's (ViT-L/14 at 224^2, the text tower
12 x 768). The towers (``models/clip_vision.py``) run in fp32 with TF32 off
for their call only (``utils.fp32_products``), on ``--device`` (default
``cuda``; ``cpu`` only when asked).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from tokenflow_torch import utils
from tokenflow_torch.io.tokenizer import CLIPTokenizer
from tokenflow_torch.models import weights as weights_lib
from tokenflow_torch.models.clip_text import CLIPTextConfig
from tokenflow_torch.models.clip_vision import CLIPScorer, CLIPVisionConfig, preprocess_images

def load_dir(d: str) -> list[np.ndarray]:
    """The PNG (else JPG) frames of ``d``, sorted, as float32 (H, W, 3) in
    [0, 1]."""
    paths = sorted(glob.glob(os.path.join(d, "*.png"))) or sorted(
        glob.glob(os.path.join(d, "*.jpg"))
    )
    if not paths:
        raise FileNotFoundError(f"no frames in {d}")
    return [np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0 for p in paths]


def clip_geometry(ckpt: str) -> tuple[CLIPVisionConfig, CLIPTextConfig, int]:
    """(vision config, text config, eos id) from an HF ``CLIPModel``
    directory's config.json, else ViT-L/14's. A legacy ``eos_token_id`` of
    2 reads as 49407, as HF pools it (the JAX script pools it at id 2)."""
    cfg_path = os.path.join(ckpt, "config.json") if os.path.isdir(ckpt) else None
    if not (cfg_path and os.path.exists(cfg_path)):
        # sd15(): SD-1.5's text encoder is CLIP ViT-L/14's text tower
        return CLIPVisionConfig.vit_l_14(), CLIPTextConfig.sd15(), 49407
    with open(cfg_path) as f:
        hf = json.load(f)
    v, t = hf["vision_config"], hf["text_config"]
    vision = CLIPVisionConfig(
        hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
        num_heads=v["num_attention_heads"], intermediate_size=v["intermediate_size"],
        image_size=v["image_size"], patch_size=v["patch_size"],
        projection_dim=hf.get("projection_dim", 768),
        hidden_act=v.get("hidden_act", "quick_gelu"),
    )
    text = CLIPTextConfig(
        vocab_size=t.get("vocab_size", 49408), hidden_size=t["hidden_size"],
        num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
        intermediate_size=t["intermediate_size"],
        hidden_act=t.get("hidden_act", "quick_gelu"),
    )
    eos = t.get("eos_token_id", 49407)
    # openai/clip-vit-large-patch14's own config says 2, a legacy value that
    # HF pools at argmax(ids): CLIP's end-of-text id, the highest it emits
    return vision, text, 49407 if eos == 2 else eos


def load_scorer(ckpt: str, device: torch.device | str) -> tuple[CLIPScorer, Optional[CLIPTokenizer]]:
    """An HF ``CLIPModel`` checkpoint in the port's ``CLIPScorer`` (fp32, on
    ``device``; keys by name, only ``position_ids`` and ``logit_scale``
    dropped), and its tokenizer where the directory has one."""
    if os.path.isdir(ckpt):
        sd = weights_lib.load_component_state_dict(ckpt)
    else:
        sd = weights_lib.load_file(ckpt)
    sd = {k: v.float() for k, v in weights_lib.normalize_state_dict(sd, "clip").items()}
    vision, text, eos_id = clip_geometry(ckpt)
    with torch.device("meta"):
        scorer = CLIPScorer(vision, text, eos_token_id=eos_id)
    scorer.load_state_dict(sd, strict=True, assign=True)
    scorer = scorer.to(device).eval().requires_grad_(False)
    tok = None
    if os.path.isdir(ckpt) and os.path.exists(os.path.join(ckpt, "vocab.json")):
        tok = CLIPTokenizer.from_pretrained(ckpt)
    return scorer, tok


@torch.inference_mode()
def image_features(scorer: CLIPScorer, frames, batch: int = 16) -> torch.Tensor:
    """L2-normalized CLIP image embeddings of (F, H, W, 3) frames in [0, 1],
    fp32 with TF32 off, on the scorer's device, ``batch`` frames a call."""
    device = next(scorer.parameters()).device
    frames = torch.as_tensor(np.asarray(frames, np.float32))
    out = []
    with utils.fp32_products():
        for i in range(0, len(frames), batch):
            pixels = preprocess_images(frames[i : i + batch].to(device),
                                       scorer.vision_config.image_size)
            out.append(scorer.image_features(pixels))
    return torch.cat(out)


@torch.inference_mode()
def text_features(scorer: CLIPScorer, ids) -> torch.Tensor:
    """L2-normalized CLIP text embeddings of (B, 77) token ids, fp32 with
    TF32 off."""
    device = next(scorer.parameters()).device
    with utils.fp32_products():
        return scorer.text_features(torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                                    device=device))


def clip_metrics(frames, prompt: Optional[str], scorer: CLIPScorer, tokenizer) -> dict:
    """Temporal consistency (mean cosine of consecutive frames' image
    embeddings) and, with a tokenizer and a prompt, the CLIP score of each
    frame against the prompt (mean and min), rounded as the JAX script
    rounds them."""
    img = image_features(scorer, frames).double().cpu().numpy()
    consec = np.sum(img[1:] * img[:-1], axis=-1)
    out = {"clip_temporal_consistency": round(float(consec.mean()), 4)}
    if tokenizer is not None and prompt:
        # bos + tokens + eos, padded to 77: the text tower pools at the
        # first eos, so the special tokens matter
        txt = text_features(scorer, [tokenizer(prompt)]).double().cpu().numpy()
        score = np.maximum(img @ txt[0], 0.0) * 100.0
        out["clip_score_mean"] = round(float(score.mean()), 3)
        out["clip_score_min"] = round(float(score.min()), 3)
    return out


def psnr_report(a: list, b: list) -> dict:
    n = min(len(a), len(b))
    per_frame = [utils.psnr(a[i], b[i]) for i in range(n)]
    return {
        "frames_compared": n,
        "psnr_per_frame": [round(float(p), 3) for p in per_frame],
        "psnr_mean": round(float(np.mean(per_frame)), 3),
        "psnr_min": round(float(np.min(per_frame)), 3),
    }


def compare(dir_a: str, dir_b: str, clip_ckpt: Optional[str] = None,
            prompt: Optional[str] = None, device: str = "cuda") -> dict:
    """The report of DIR_A against DIR_B (module docstring)."""
    a, b = load_dir(dir_a), load_dir(dir_b)
    report = psnr_report(a, b)
    if clip_ckpt:
        scorer, tok = load_scorer(clip_ckpt, utils.resolve_device(device))
        report.update(clip_metrics(a, prompt, scorer, tok))
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--out", default=None)
    ap.add_argument("--clip_ckpt", default=None,
                    help="HF CLIPModel checkpoint (dir or file) for CLIP metrics")
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    report = compare(args.dir_a, args.dir_b, args.clip_ckpt, args.prompt, args.device)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
