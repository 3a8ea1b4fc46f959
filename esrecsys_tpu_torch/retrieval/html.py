"""HTML result pages for looking at retrieval results by eye (counterpart
of ``esrecsys_tpu/retrieval/html.py``; the pages are byte-equal to the
reference's): one page per query with image tags, and the random-item
baseline's page."""

from __future__ import annotations

import html
import os
from typing import Callable, Iterable, Sequence, Tuple


def render_results_page(
    query_id: str,
    results: Sequence[Tuple[str, float]],
    id_to_url: Callable[[str], str],
    title: str = "Recommendations",
) -> str:
    rows = "\n".join(
        f'<tr><td><img src="{html.escape(id_to_url(rid))}" width="200"></td>'
        f"<td>{html.escape(rid)}</td><td>{score:.4f}</td></tr>"
        for rid, score in results
    )
    return f"""<html><head><title>{html.escape(title)}</title></head><body>
<h1>{html.escape(title)}</h1>
<h2>Query</h2>
<img src="{html.escape(id_to_url(query_id))}" width="300">
<h2>Results</h2>
<table border="1"><tr><th>image</th><th>id</th><th>score</th></tr>
{rows}
</table></body></html>"""


def save_results_pages(
    out_dir: str,
    per_query_results: Iterable[Tuple[str, Sequence[Tuple[str, float]]]],
    id_to_url: Callable[[str], str],
    max_pages: int = 100,
) -> int:
    """Write one page per query, at most ``max_pages``, as
    ``<n:05d>_<query id[:16]>.html``; returns the count written."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for query_id, results in per_query_results:
        if n >= max_pages:
            break
        page = render_results_page(query_id, results, id_to_url)
        with open(os.path.join(out_dir, f"{n:05d}_{query_id[:16]}.html"),
                  "w") as f:
            f.write(page)
        n += 1
    return n
