"""Polite image fetcher for the Shop-the-Look dataset (counterpart of
``esrecsys_tpu/etl/fetch_images.py``): the scene and product keys deduped
in first-seen order, files already on disk skipped, each fetch retried
with an additive backoff (``backoff_seconds`` more after each failure) up
to ``max_retries`` times, a pause of ``sleep_seconds`` every
``sleep_every`` keys, and the failures counted at the end.

  python -m esrecsys_tpu_torch.etl.fetch_images --stl_json pairs.json \
      --image_dir images/
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import urllib.request
from typing import Dict, List

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import images as images_lib

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FetchConfig:
    stl_json: str = ""
    image_dir: str = "images"
    sleep_every: int = 100       # pause cadence
    sleep_seconds: float = 1.0
    max_retries: int = 10        # capped, not forever
    backoff_seconds: float = 1.0  # additive: +backoff after each failure


def unique_keys(stl_json: str) -> List[str]:
    """Every scene and product key once, in first-seen order."""
    seen: Dict[str, None] = {}
    for s, p in images_lib.load_scene_product_pairs(stl_json):
        seen.setdefault(s)
        seen.setdefault(p)
    return list(seen)


def fetch_one(key: str, image_dir: str, max_retries: int,
              backoff: float) -> bool:
    path = images_lib.key_to_filename(key, image_dir)
    if os.path.isfile(path) and os.path.getsize(path) > 0:
        return True  # resume: skip what is on disk
    url = images_lib.key_to_url(key)
    delay = backoff
    for attempt in range(max_retries):
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                data = r.read()
            with open(path, "wb") as f:
                f.write(data)
            return True
        except Exception as e:  # noqa: BLE001 - any fetch error retries
            log.warning("fetch %s attempt %d failed: %s", key, attempt + 1, e)
            time.sleep(delay)
            delay += backoff
    return False


def fetch_all(cfg: FetchConfig) -> dict:
    os.makedirs(cfg.image_dir, exist_ok=True)
    keys = unique_keys(cfg.stl_json)
    log.info("%d unique images", len(keys))
    ok = failed = 0
    for i, key in enumerate(keys):
        if fetch_one(key, cfg.image_dir, cfg.max_retries,
                     cfg.backoff_seconds):
            ok += 1
        else:
            failed += 1
            log.error("giving up on %s", key)
        if cfg.sleep_every and (i + 1) % cfg.sleep_every == 0:
            time.sleep(cfg.sleep_seconds)
    log.info("done: %d ok, %d failed", ok, failed)
    return {"ok": ok, "failed": failed}


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True)
    return fetch_all(config_lib.from_cli(FetchConfig, argv))


if __name__ == "__main__":
    main()
