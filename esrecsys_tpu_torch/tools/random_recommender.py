"""Random-catalog baseline recommender -> an HTML page (counterpart of
``esrecsys_tpu/tools/random_recommender.py``; the same page for a seed):
random products in a results table, the no-model baseline.

  python -m esrecsys_tpu_torch.tools.random_recommender --stl_json pairs.json \
      --output_html runs/random.html --num_items 20
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import images as images_lib
from esrecsys_tpu_torch.retrieval.html import render_results_page


@dataclasses.dataclass(frozen=True)
class RandomRecConfig:
    stl_json: str = ""
    output_html: str = os.path.join(tempfile.gettempdir(),
                                    "random_items.html")
    num_items: int = 20
    seed: int = 0


def main(argv=None) -> str:
    cfg = config_lib.from_cli(RandomRecConfig, argv)
    pairs = images_lib.load_scene_product_pairs(cfg.stl_json)
    products = sorted({p for _, p in pairs})
    rng = np.random.default_rng(cfg.seed)
    picks = [products[i] for i in rng.integers(0, len(products),
                                               cfg.num_items)]
    page = render_results_page(
        picks[0], [(p, 0.0) for p in picks], images_lib.key_to_url,
        title="Random item baseline")
    with open(cfg.output_html, "w") as f:
        f.write(page)
    print(f"wrote {cfg.output_html}")
    return cfg.output_html


if __name__ == "__main__":
    main()
