"""Query-side model encoders for the online retrieval service
(counterpart of ``esrecsys_tpu/serving/encoders.py``).

Each factory loads a trained model artifact of either package
(``train/export.py``) and returns a callable that embeds one raw query
into the index's vector space: text through the txt2url sentence tower
(its word lookup on the row-gather kernel on a card), a catalog image key
through an STL tower with its running statistics. The server registers
them as ``encoders={"text": ..., "image_key": ...}``.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from esrecsys_tpu_torch import convert
from esrecsys_tpu_torch.core.device import resolve_device
from esrecsys_tpu_torch.data import images as images_lib
from esrecsys_tpu_torch.data.vocab import Vocabulary, simple_tokenize
from esrecsys_tpu_torch.models.cnn import pin_full_f32

log = logging.getLogger(__name__)


def txt2url_text_encoder(artifact_path: str, token_dictionary: str,
                         sentence_length: Optional[int] = None,
                         device=None) -> Callable[[str], np.ndarray]:
    """text -> url-space embedding through a txt2url artifact. Tokens as in
    training (``simple_tokenize`` and the dictionary's minhash buckets for
    unknown words), cut or zero-padded to ``sentence_length`` (default:
    the artifact's, else 32). Runs on ``device`` (default: the card)."""
    device = resolve_device(device)
    model, meta = convert.txt2url_model_from_artifact(artifact_path, device)
    model.eval()
    vocab = Vocabulary.load(token_dictionary)
    length = sentence_length or int(meta.get("sentence_length", 32))

    def encoder(text: str) -> np.ndarray:
        ids = vocab.embedding_indices(simple_tokenize(text))[:length]
        row = torch.tensor([ids + [0] * (length - len(ids))],
                           dtype=torch.int32, device=device)
        with torch.no_grad():
            return model.encode_text(row)[0].cpu().numpy()

    return encoder


def stl_image_encoder(artifact_path: str, image_dir: str,
                      image_size: Optional[int] = None, tower: str = "scene",
                      device=None) -> Callable[[str], np.ndarray]:
    """catalog image key -> embedding through an STL artifact's ``tower``
    ("scene" or "product"), float32 as the reference's encoder builds it
    (TF32 off on a card), the image decoded as the index's were
    (``keyed_image_dataset`` at ``image_size``, default the artifact's).
    A key without an image raises."""
    if tower not in ("scene", "product"):
        raise ValueError(f"tower must be 'scene' or 'product', got {tower!r}")
    device = resolve_device(device)
    if device.type == "cuda":
        pin_full_f32()
    model, meta = convert.stl_model_from_artifact(artifact_path,
                                                  device=device)
    size = image_size or int(meta["image_size"])
    embed = model.scene_embed if tower == "scene" else model.product_embed

    def encoder(key: str) -> np.ndarray:
        _, img, _ = next(iter(images_lib.keyed_image_dataset(
            [key], image_dir, 1, size)))
        with torch.no_grad():
            return embed(torch.from_numpy(img).to(device))[0].cpu().numpy()

    return encoder
