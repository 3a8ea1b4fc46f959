"""Wikipedia ETL (counterpart of ``esrecsys_tpu/etl/wiki.py``): a
MediaWiki XML dump -> ``Page`` shards -> ``TextDocument`` shards.

``xml_to_pages`` streams the dump with ``xml.etree`` ``iterparse`` (the
namespace prefix taken from the root tag, each page cleared once read)
into ``part-NNNNN.bz2`` shards of ``pages_per_shard`` pages.
``tokenize_pages`` drops redirects, pages without a title or a revision
and the namespaces of ``TITLE_REJECT_RE``, and writes each page as its
URL, its links' URLs (``[[target|shown]]`` targets, namespace-filtered,
de-duplicated and sorted) and its tokens (the native tokenizer, equal to
``data/vocab.simple_tokenize``, which it falls back to where the native
library cannot be built), less any stopwords.

CLI:
  python -m esrecsys_tpu_torch.etl.wiki --mode xml2proto --input dump.xml --output pages/
  python -m esrecsys_tpu_torch.etl.wiki --mode tokenize  --input 'pages/part-*' --output docs/
"""

from __future__ import annotations

import dataclasses
import logging
import re
import urllib.parse
from typing import Callable, Iterator, List, Optional, Set
from xml.etree import ElementTree

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import recordio
from esrecsys_tpu_torch.data.protos import Page, Revision, TextDocument
from esrecsys_tpu_torch.data.vocab import simple_tokenize

log = logging.getLogger(__name__)

# pages in these namespaces are not for readers
TITLE_REJECT_RE = re.compile(
    r"^Wikipedia:|^User:|^File:|^MediaWiki:|^Template:|^Help:|^Portal:|^Draft:"
)
LINK_RE = re.compile(r"\[\[[^\]]*\]\]")

_tokenize_impl: Optional[Callable[[str], List[str]]] = None


def tokenizer() -> Callable[[str], List[str]]:
    """The native tokenizer, or ``simple_tokenize`` where the native
    library cannot be built (decided once a process, at the first call:
    the library builds then)."""
    global _tokenize_impl
    if _tokenize_impl is None:
        try:
            from esrecsys_tpu_torch.native import tokenize as native_tokenize

            native_tokenize("probe Build")
            _tokenize_impl = native_tokenize
        except (OSError, RuntimeError) as e:
            log.info("native tokenizer unavailable (%s); using "
                     "simple_tokenize", e)
            _tokenize_impl = simple_tokenize
    return _tokenize_impl


# ------------------------------------------------------------ xml2proto

def _parse_revision(el, nslen: int) -> Revision:
    rev = Revision()
    for child in el:
        tag = child.tag[nslen:]
        if tag in ("id", "parentid"):
            setattr(rev, tag, int(child.text or 0))
        elif tag in ("timestamp", "model", "format", "sha1", "text"):
            setattr(rev, tag, child.text or "")
        elif tag == "minor":
            rev.minor = True
    return rev


def iter_pages(xml_path: str) -> Iterator[Page]:
    """Stream the ``Page`` messages of a MediaWiki XML export in constant
    memory."""
    it = ElementTree.iterparse(xml_path, events=("start", "end"))
    _, root = next(it)
    xmlns = (root.tag[:-len("mediawiki")] if root.tag.endswith("mediawiki")
             else "")
    nslen = len(xmlns)
    for ev, el in it:
        if ev != "end" or el.tag[nslen:] != "page":
            continue
        page = Page()
        for child in el:
            tag = child.tag[nslen:]
            if tag == "title":
                page.title = child.text or ""
            elif tag == "ns":
                page.ns = int(child.text or 0)
            elif tag == "id":
                page.id = int(child.text or 0)
            elif tag == "redirect":
                page.redirect_title = child.attrib.get("title", "")
            elif tag == "revision":
                page.revision.append(_parse_revision(child, nslen))
        yield page
        el.clear()
        root.clear()


def xml_to_pages(xml_path: str, output_dir: str,
                 pages_per_shard: int = 1000) -> int:
    """XML dump -> ``part-NNNNN.bz2`` shards of ``Page`` messages; returns
    the page count."""
    with recordio.ShardedWriter(output_dir, pages_per_shard) as w:
        for page in iter_pages(xml_path):
            w.write_proto(page)
        total = w.total
    log.info("wrote %d pages to %s", total, output_dir)
    return total


# ------------------------------------------------------------- tokenize

def normalize_title_url(title: str) -> str:
    """Title -> canonical enwiki URL: spaces to underscores, characters
    outside the URL-safe set percent-encoded (UTF-8)."""
    path = title.replace(" ", "_")
    quoted = urllib.parse.quote(path, safe="/:()_',.-~!*$&+=@;")
    return f"https://en.wikipedia.org/wiki/{quoted}"


def extract_links(text: str) -> List[str]:
    """The ``[[target|shown]]`` link targets of a page's text, outside the
    rejected namespaces, de-duplicated and sorted."""
    seen: Set[str] = set()
    for block in LINK_RE.findall(text):
        target = block.strip("[]").split("|")[0]
        if target and not TITLE_REJECT_RE.match(target):
            seen.add(target)
    return sorted(seen)


def page_to_doc(page: Page, stopwords: Optional[Set[str]] = None
                ) -> Optional[TextDocument]:
    """A page's ``TextDocument``, or None for a redirect, a page without a
    title or a revision, or one in a rejected namespace."""
    if page.redirect_title or not page.title or not page.revision:
        return None
    if TITLE_REJECT_RE.match(page.title):
        return None
    text = page.revision[0].text
    tokens = tokenizer()(text)
    if stopwords:
        tokens = [t for t in tokens if t not in stopwords]
    return TextDocument(
        primary=normalize_title_url(page.title),
        secondary=[normalize_title_url(t) for t in extract_links(text)],
        tokens=tokens)


def tokenize_pages(input_pattern: str, output_dir: str,
                   docs_per_shard: int = 1000,
                   stopwords_file: str = "") -> int:
    """``Page`` shards -> ``TextDocument`` shards (corrupt records
    skipped); returns the document count. ``stopwords_file`` holds one
    stopword a line."""
    stopwords = None
    if stopwords_file:
        with open(stopwords_file) as f:
            stopwords = {line.rstrip("\n") for line in f if line.strip()}
        log.info("%d stopwords loaded", len(stopwords))
    n = 0
    with recordio.ShardedWriter(output_dir, docs_per_shard) as w:
        for page in recordio.read_protos(input_pattern, Page,
                                         skip_corrupt=True):
            doc = page_to_doc(page, stopwords)
            if doc is not None:
                w.write_proto(doc)
                n += 1
    log.info("wrote %d docs to %s", n, output_dir)
    return n


@dataclasses.dataclass(frozen=True)
class WikiEtlConfig:
    mode: str = "xml2proto"    # xml2proto | tokenize
    input: str = ""
    output: str = ""
    pages_per_shard: int = 1000
    stopwords: str = ""


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = config_lib.from_cli(WikiEtlConfig, argv)
    if cfg.mode == "xml2proto":
        xml_to_pages(cfg.input, cfg.output, cfg.pages_per_shard)
    elif cfg.mode == "tokenize":
        tokenize_pages(cfg.input, cfg.output, cfg.pages_per_shard,
                       cfg.stopwords)
    else:
        raise SystemExit(f"unknown --mode {cfg.mode}")


if __name__ == "__main__":
    main()
