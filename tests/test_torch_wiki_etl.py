"""The port's Wikipedia ETL chain against the JAX package's: XML dump ->
pages -> token documents -> dictionaries -> co-occurrence shards ->
sparse documents (txt2url, url2url, tf-idf) -> url co-occurrence, the
proto3 codec of those messages against protobuf's ``corpus_pb2``, the
native library (accumulator, tokenizer, base64 lines) against its Python
versions, and the ``codex`` and ``dump_correlates`` tools.

The dump is ``tests/test_wiki_etl.py``'s five pages plus pages made
from a seed (non-ASCII titles and text, namespaces, redirects, tied
counts, long documents whose rows split). protobuf runs only on the JAX
side and in the codec checks.

Tolerance: none but one. Every shard's records are byte-equal to the
JAX chain's (so the co-occurrence counts are exact and the tf-idf
weights equal); the tf-idf weights are also held to the float64 formula
within 1e-6.
"""

import base64
import glob
import math
import os

import numpy as np
import pytest

import test_wiki_etl
from esrecsys_tpu.data import recordio as jrecordio
from esrecsys_tpu.data import vocab as jvocab
from esrecsys_tpu.data.protos import corpus_pb2
from esrecsys_tpu.etl import cooccurrence as jcooc
from esrecsys_tpu.etl import dictionary as jdict
from esrecsys_tpu.etl import sparse_docs as jsparse
from esrecsys_tpu.etl import wiki as jwiki
from esrecsys_tpu.tools import codex as jcodex
from esrecsys_tpu.tools import dump_correlates as jdump
from esrecsys_tpu_torch import native
from esrecsys_tpu_torch.data import protos, recordio, vocab
from esrecsys_tpu_torch.etl import cooccurrence, dictionary, sparse_docs, wiki
from esrecsys_tpu_torch.tools import codex, dump_correlates

TFIDF_TOL = 1e-6
WORDS = ["alpha", "Beta", "gamma", "délta", "ÉPSILON", "zeta", "eta",
         "theta", "iota", "kappa", "lambda", "mu", "straße", "ΛΌΓΟΣ"]
TITLES = ["Alpha Beta", "Gamma Page", "Delta", "Łódź", "C++ (language)",
          "Zeta_Function", "Ünïcode Page", "A/B testing", "50% rule",
          "Kappa?"]


def _seeded_pages(rng):
    """Pages made from ``rng``: articles with links (some to other
    namespaces, some with shown text, some repeated), a redirect, a
    namespace page, an empty text and a page without a revision."""
    out = []
    for i, title in enumerate(TITLES):
        words = rng.choice(WORDS, int(rng.integers(3, 60)))
        links = rng.choice(TITLES + ["User:Someone", "File:x.png"],
                           int(rng.integers(0, 5)))
        body = " ".join(words) + " " + " ".join(
            f"[[{t}|shown {j}]]" if j % 2 else f"[[{t}]]"
            for j, t in enumerate(links)) + " x_y, (z) 'q' a\\b"
        out.append(f"<page><title>{title}</title><ns>0</ns><id>{100 + i}"
                   f"</id><revision><id>{200 + i}</id><parentid>{i}"
                   f"</parentid><minor/><timestamp>2020</timestamp>"
                   f"<contributor><username>u</username></contributor>"
                   f"<text>{body}</text></revision></page>")
    out.append("<page><title>Old Name</title><ns>0</ns><id>300</id>"
               "<redirect title=\"Delta\"/><revision><id>301</id><text>"
               "#REDIRECT [[Delta]]</text></revision></page>")
    out.append("<page><title>Template:Box</title><ns>10</ns><id>302</id>"
               "<revision><id>303</id><text>box [[Delta]]</text>"
               "</revision></page>")
    out.append("<page><title>Empty</title><ns>0</ns><id>304</id>"
               "<revision><id>305</id><text></text></revision></page>")
    out.append("<page><title>No Revision</title><ns>0</ns><id>306</id>"
               "</page>")
    return out


def _xml():
    fixture = test_wiki_etl.XML
    extra = "".join(_seeded_pages(np.random.default_rng(0)))
    return fixture.replace("</mediawiki>", extra + "</mediawiki>")


def _run_chain(pkg, xml, out):
    """The chain as the reference's README runs it, in one package."""
    wiki_m, dict_m, cooc_m, sparse_m, vocab_m = pkg
    wiki_m.xml_to_pages(xml, f"{out}/pages", pages_per_shard=4)
    wiki_m.tokenize_pages(f"{out}/pages/part-*", f"{out}/docs",
                          docs_per_shard=5)
    docs = f"{out}/docs/part-*"
    dict_m.build_token_dictionary(docs, min_frequency=2).save(
        f"{out}/tokens.bz2")
    dict_m.build_title_dictionary(docs, min_frequency=1).save(
        f"{out}/titles.bz2")
    tok = vocab_m.Vocabulary.load(f"{out}/tokens.bz2")
    titles = vocab_m.Vocabulary.load(f"{out}/titles.bz2")
    cooc_m.build_token_cooccurrence(docs, tok, f"{out}/cooc", window=3,
                                    max_row_size=4, rows_per_shard=7)
    for mode in ("txt2url", "url2url", "tfidf"):
        sparse_m.convert(mode, docs, f"{out}/{mode}",
                         None if mode == "url2url" else tok, titles,
                         docs_per_shard=3)
    cooc_m.build_url_cooccurrence(f"{out}/url2url/part-*", f"{out}/url_cooc",
                                  max_row_size=2, rows_per_shard=3)
    return out


STAGES = ("pages", "docs", "tokens.bz2", "titles.bz2", "cooc", "txt2url",
          "url2url", "tfidf", "url_cooc")


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wiki_chain")
    xml = str(tmp / "dump.xml")
    with open(xml, "w", encoding="utf-8") as f:
        f.write(_xml())
    jax_out = _run_chain((jwiki, jdict, jcooc, jsparse, jvocab), xml,
                         str(tmp / "jax"))
    port_out = _run_chain((wiki, dictionary, cooccurrence, sparse_docs,
                           vocab), xml, str(tmp / "torch"))
    with pytest.MonkeyPatch.context() as mp:  # the Python accumulator
        mp.setattr(cooccurrence, "make_accumulator",
                   cooccurrence.PyCoocAccumulator)
        py_out = _run_chain((wiki, dictionary, cooccurrence, sparse_docs,
                             vocab), xml, str(tmp / "torch_py"))
    return xml, jax_out, port_out, py_out


def _files(root, stage):
    path = os.path.join(root, stage)
    if os.path.isdir(path):
        return sorted(os.path.relpath(p, root)
                      for p in glob.glob(os.path.join(path, "part-*")))
    return [stage]


def _records(root, rel):
    return list(jrecordio.read_records(os.path.join(root, rel),
                                       native=False))


@pytest.mark.parametrize("stage", STAGES)
def test_every_stage_writes_the_reference_bytes(chains, stage):
    _, jax_out, port_out, _ = chains
    names = _files(jax_out, stage)
    assert names and names == _files(port_out, stage)
    for rel in names:
        got, want = _records(port_out, rel), _records(jax_out, rel)
        assert len(got) == len(want) > 0, rel
        assert got == want, rel


@pytest.mark.parametrize("stage", ["cooc", "url_cooc"])
def test_python_accumulator_writes_the_same_rows(chains, stage):
    _, jax_out, _, py_out = chains
    for rel in _files(jax_out, stage):
        assert _records(py_out, rel) == _records(jax_out, rel), rel


def test_chain_contents(chains):
    """What the stages hold, read back with the port's codec."""
    _, _, out, _ = chains
    pages = list(recordio.read_protos(f"{out}/pages/part-*", protos.Page))
    assert len(pages) == 5 + len(TITLES) + 4
    assert pages[1].redirect_title == "Alpha Beta"
    rev = pages[5].revision[0]
    assert (rev.id, rev.parentid, rev.minor, rev.timestamp) == (200, 0, True,
                                                                "2020")
    assert rev.contributor is None  # the reference does not read it
    docs = list(recordio.read_protos(f"{out}/docs/part-*",
                                     protos.TextDocument))
    # redirects, namespaces and the page without a revision are dropped
    assert len(docs) == 3 + len(TITLES) + 1
    assert docs[0].secondary == ["https://en.wikipedia.org/wiki/Delta",
                                 "https://en.wikipedia.org/wiki/Gamma_Page"]
    urls = [d.primary for d in docs]
    assert "https://en.wikipedia.org/wiki/%C5%81%C3%B3d%C5%BA" in urls
    assert "https://en.wikipedia.org/wiki/C++_(language)" in urls
    for row in recordio.read_protos(f"{out}/cooc/part-*",
                                    protos.CooccurrenceRow):
        assert len(row.other_index) <= 4
        assert all(row.index > o for o in row.other_index)


def test_tfidf_weights_match_the_formula(chains):
    _, _, out, _ = chains
    tok = vocab.Vocabulary.load(f"{out}/tokens.bz2")
    titles = vocab.Vocabulary.load(f"{out}/titles.bz2")
    sdocs = iter(recordio.read_protos(f"{out}/tfidf/part-*",
                                      protos.SparseDocument))
    max_df = tok.max_doc_frequency
    n = 0
    for doc in recordio.read_protos(f"{out}/docs/part-*",
                                    protos.TextDocument):
        ids = [tok.token_index(t) for t in doc.tokens]
        ids = [i for i in ids if i is not None]
        if not ids:  # no token in the dictionary: no sparse document
            continue
        sd = next(sdocs)
        n += 1
        assert sd.url == doc.primary
        assert sd.primary_index == titles.token_index(sd.url)
        want = np.array([ids.count(i) * max(
            math.log1p(max_df) - math.log1p(tok.doc_frequency(i)) + 1.0, 0)
            for i in sorted(set(ids))])
        want /= np.linalg.norm(want) or 1.0
        assert sd.token_index == sorted(set(ids))
        np.testing.assert_allclose(sd.token_tfidf, want, rtol=0,
                                   atol=TFIDF_TOL)
    assert n and next(sdocs, None) is None


def test_dictionaries_keep_the_reference_tie_order(chains):
    _, jax_out, out, _ = chains
    for name in ("tokens.bz2", "titles.bz2"):
        ours = vocab.Vocabulary.load(f"{out}/{name}")
        theirs = jvocab.Vocabulary.load(f"{jax_out}/{name}")
        assert [ours.token(i) for i in range(len(ours))] == [
            theirs.token(i) for i in range(len(theirs))]
        freqs = [ours.frequency(i) for i in range(len(ours))]
        assert len(set(freqs)) < len(freqs)  # ties were ordered


# ------------------------------------------------------------------ codec

def _codec_cases():
    rng = np.random.default_rng(3)
    return [
        ("TextDocument", dict(primary="p", secondary=["a", "", "ü"],
                              tokens=["x"] * 3 + ["ΛΌΓΟΣ"], url="u")),
        ("TextDocument", dict()),
        ("SparseDocument", dict(url="u", primary_index=2 ** 40,
                                secondary_index=[0, 1, 300],
                                token_index=rng.integers(0, 2 ** 20, 50),
                                token_tfidf=rng.random(50))),
        ("SparseDocument", dict(token_tfidf=[0.0, -0.0, 1e-45, 3e38])),
        ("Contributor", dict(username="u", id=-(2 ** 63), ip="::1")),
        ("Revision", dict(id=2 ** 63 - 1, parentid=-1, timestamp="t",
                          minor=True, model="wikitext", format="x",
                          sha1="s", text="a\tb\n'c' \"d\" \\ \x01")),
        ("Page", dict(title="Łódź", ns=-2, id=7, redirect_title="r")),
    ]


@pytest.mark.parametrize("case", range(7))
def test_codec_matches_protobuf_both_ways(case):
    name, fields = _codec_cases()[case]
    ours = getattr(protos, name)(**fields)
    theirs = getattr(corpus_pb2, name)(**fields)
    assert ours.SerializeToString() == theirs.SerializeToString()
    assert getattr(protos, name).FromString(
        theirs.SerializeToString()) == ours
    assert getattr(corpus_pb2, name).FromString(
        ours.SerializeToString()) == theirs
    assert str(ours) == str(theirs)


def test_nested_messages_match_protobuf():
    theirs = corpus_pb2.Page(title="T", id=1)
    r = theirs.revision.add()
    r.id, r.minor, r.text = 3, True, "body"
    r.contributor.username = "u"
    theirs.revision.add().contributor.SetInParent()  # present, empty
    theirs.revision.add()
    ours = protos.Page(title="T", id=1, revision=[
        protos.Revision(id=3, minor=True, text="body",
                        contributor=protos.Contributor(username="u")),
        protos.Revision(contributor=protos.Contributor()),
        protos.Revision()])
    data = theirs.SerializeToString()
    assert ours.SerializeToString() == data
    assert protos.Page.FromString(data) == ours
    assert str(ours) == str(theirs)
    # a message field that appears twice merges, as protobuf's does
    twice = (protos._tag(4, protos.LEN) + bytes([3]) + b"\x0a\x01a"
             + protos._tag(4, protos.LEN) + bytes([2]) + b"\x10\x05")
    rev = protos.Revision.FromString(twice)
    want = corpus_pb2.Revision.FromString(twice)
    assert (rev.contributor.username, rev.contributor.id) == (
        want.contributor.username, want.contributor.id) == ("a", 5)


def test_codec_reads_unpacked_sparse_documents():
    msg = (protos._tag(4, protos.VARINT) + protos.encode_varint(300)
           + protos._tag(5, protos.I32) + np.float32(0.25).tobytes()
           + protos._tag(4, protos.VARINT) + protos.encode_varint(2)
           + protos._tag(2, protos.VARINT) + protos.encode_varint(9))
    got = protos.SparseDocument.FromString(msg)
    want = corpus_pb2.SparseDocument.FromString(msg)
    assert (got.token_index, got.token_tfidf, got.primary_index) == (
        list(want.token_index), list(want.token_tfidf),
        want.primary_index) == ([300, 2], [0.25], 9)


@pytest.mark.parametrize("stage,cls", [("pages", "Page"),
                                       ("docs", "TextDocument"),
                                       ("txt2url", "SparseDocument"),
                                       ("tfidf", "SparseDocument")])
def test_protobuf_reserializes_what_the_port_wrote(chains, stage, cls):
    _, _, out, _ = chains
    for rel in _files(out, stage):
        for raw in _records(out, rel):
            assert getattr(corpus_pb2, cls).FromString(
                raw).SerializeToString() == raw


# ----------------------------------------------------------------- native

def test_native_library_builds_outside_the_sources():
    path = native.library_path()
    native.load()
    assert path.is_file() and path.parent.name == "_build"
    src_dir = os.path.dirname(native.__file__)
    assert not glob.glob(os.path.join(src_dir, "*.so"))


@pytest.mark.parametrize("mode", ["window", "pairs"])
def test_native_accumulator_matches_python(mode):
    rng = np.random.default_rng(1)
    py, cc = cooccurrence.PyCoocAccumulator(), native.NativeCoocAccumulator()
    for _ in range(30):
        ids = rng.integers(0, 60, int(rng.integers(0, 90))).tolist()
        for acc in (py, cc):
            if mode == "window":
                acc.add_window(ids, 5)
            else:
                acc.add_pairs(ids)
    for a, b in zip(py.export(), cc.export()):
        np.testing.assert_array_equal(a, b)
    assert type(cooccurrence.make_accumulator()) is \
        native.NativeCoocAccumulator


@pytest.mark.parametrize("max_row_size", [1, 3, 1000])
def test_rows_from_accumulator_match_the_reference(max_row_size):
    rng = np.random.default_rng(2)
    acc, jacc = native.NativeCoocAccumulator(), jcooc.PyCoocAccumulator()
    for _ in range(20):
        ids = rng.integers(0, 300, int(rng.integers(1, 60))).tolist()
        acc.add_window(ids, 4)
        jacc.add_window(ids, 4)
    want = [r.SerializeToString()
            for r in jcooc.rows_from_accumulator(jacc, max_row_size)]
    got = [r.SerializeToString()
           for r in cooccurrence.rows_from_accumulator(acc, max_row_size)]
    assert got == want
    assert list(cooccurrence.rows_from_accumulator(
        cooccurrence.PyCoocAccumulator(), 5)) == []


def test_window_weighting_closed_form():
    for acc in (cooccurrence.PyCoocAccumulator(),
                native.NativeCoocAccumulator()):
        acc.add_window([5, 9, 5, 2], window=10)
        rows, others, counts = acc.export()
        got = {(int(r), int(o)): c for r, o, c in zip(rows, others, counts)}
        assert got == {(5, 2): 1.0 + 1.0 / 3.0, (9, 2): 0.5, (9, 5): 2.0}


def test_native_tokenizer_matches_simple_tokenize():
    cases = ["", "   ", "The Quick BROWN fox! jumps,over;the:lazy dog",
             "café NAÏVE Straße ΛΌΓΟΣ мОсКвА [[Link|x]] a_b c\td",
             "unicode: ÀÉÎÕÜ ß ﬁ Ⅷ ȘțĂâ İstanbul", "\n\nnl\nand\ttabs\t"]
    rng = np.random.default_rng(0)
    cases.append(" ".join(rng.choice(WORDS + ["a'b", "x|y", "İ"], 3000)))
    for text in cases:
        want = jvocab.simple_tokenize(text)
        assert native.tokenize(text) == want
        assert vocab.simple_tokenize(text) == want
        assert wiki.tokenizer()(text) == want


def _read_records(monkeypatch, path, use_native):
    """``recordio.read_records``, with the native decoder or without."""
    with monkeypatch.context() as mp:
        if not use_native:
            mp.setattr(recordio, "_native_decoder", lambda: None)
        return list(recordio.read_records(path))


def test_b64_lines_decode_and_refuse_garbage(tmp_path, monkeypatch):
    payloads = [b"hello world", b"", b"\x00\xff\x01" * 7, b"x", b"ab"]
    blob = b"\n".join(base64.b64encode(p) for p in payloads) + b"\n"
    assert native.decode_b64_lines(blob) == payloads
    path = str(tmp_path / "ok.gz")
    recordio.write_records(path, payloads)
    for use_native in (True, False):
        assert _read_records(monkeypatch, path, use_native) == \
            payloads == list(jrecordio.read_records(path))
    for bad in (b"!!notb64!!", b"a", b"QQ=x", b"QQ===", b"QUJD=",
                b"aGVs bG8="):
        with pytest.raises(ValueError, match="line 1"):
            native.decode_b64_lines(b"aGVsbG8=\n" + bad + b"\n")
        path = str(tmp_path / "bad.bz2")
        with open(path.replace(".bz2", ".txt"), "wb") as f:
            f.write(b"aGVsbG8=\n" + bad + b"\n")
        for use_native in (True, False):
            with pytest.raises(ValueError):
                _read_records(monkeypatch, path.replace(".bz2", ".txt"),
                              use_native)


# --------------------------------------------------------- vocab helpers

def test_vocab_helpers_match_the_reference():
    docs = [["a", "b", "a"], ["b", "c"], [], ["a"]]
    assert vocab.count_tokens(docs) == jvocab.count_tokens(docs)
    ids = np.array([-5, 0, 7, 100_001], np.int64)
    np.testing.assert_array_equal(vocab.mod_hash(ids, 1000),
                                  jvocab.mod_hash(ids, 1000))
    assert vocab.mod_hash(123_456, 1000) == jvocab.mod_hash(123_456, 1000)
    import torch

    np.testing.assert_array_equal(
        vocab.mod_hash(torch.from_numpy(ids), 1000).numpy(),
        np.asarray(jvocab.mod_hash(__import__("jax").numpy.asarray(ids),
                                   1000)))


# ------------------------------------------------------------------ tools

@pytest.mark.parametrize("proto,stage", [("wiki", "pages"), ("doc", "docs"),
                                         ("sdoc", "tfidf"),
                                         ("tstat", "titles.bz2"),
                                         ("cooccur", "cooc")])
def test_codex_prints_what_the_reference_prints(chains, capsys, proto,
                                                stage):
    _, _, out, _ = chains
    pattern = (f"{out}/{stage}/part-*" if os.path.isdir(f"{out}/{stage}")
               else f"{out}/{stage}")
    jcodex.main(["--input", pattern, "--proto", proto, "--limit", "4"])
    want = capsys.readouterr().out
    assert codex.main(["--input", pattern, "--proto", proto, "--limit",
                       "4"]) == 4
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("args", [
    ["--metric", "dice", "--scale", "2.0"],
    ["--metric", "count", "--topk", "3", "--limit", "0"]])
def test_dump_correlates_prints_what_the_reference_prints(chains, capsys,
                                                          args):
    _, _, out, _ = chains
    for stage, dictionary_file, extra in (
            ("url_cooc", "titles.bz2", []),
            ("cooc", "tokens.bz2", ["--embedding_indices", "true"])):
        argv = ["--input", f"{out}/{stage}/part-*", "--dictionary",
                f"{out}/{dictionary_file}"] + args + extra
        jdump.main(argv)
        want = capsys.readouterr().out
        lines = dump_correlates.main(argv)
        assert capsys.readouterr().out == want and lines


def test_clis_run_the_chain(chains, tmp_path):
    """Each stage's ``main`` with the reference's flags gives the same
    shards as the library calls."""
    xml, _, out, _ = chains
    t = str(tmp_path)
    wiki.main(["--mode", "xml2proto", "--input", xml, "--output",
               f"{t}/pages", "--pages_per_shard", "4"])
    wiki.main(["--mode", "tokenize", "--input", f"{t}/pages/part-*",
               "--output", f"{t}/docs", "--pages_per_shard", "5"])
    dictionary.main(["--input", f"{t}/docs/part-*", "--token_output",
                     f"{t}/tokens.bz2", "--title_output", f"{t}/titles.bz2",
                     "--min_token_frequency", "2", "--min_title_frequency",
                     "1"])
    cooccurrence.main(["--mode", "tokens", "--input", f"{t}/docs/part-*",
                       "--token_dictionary", f"{t}/tokens.bz2", "--output",
                       f"{t}/cooc", "--context_window", "3"])
    sparse_docs.main(["--mode", "url2url", "--input", f"{t}/docs/part-*",
                      "--title_dictionary", f"{t}/titles.bz2", "--output",
                      f"{t}/url2url", "--docs_per_shard", "3"])
    cooccurrence.main(["--mode", "urls", "--input", f"{t}/url2url/part-*",
                       "--output", f"{t}/url_cooc", "--max_row_size", "2"])
    for stage in ("pages", "docs", "tokens.bz2", "titles.bz2", "url2url"):
        for rel in _files(out, stage):
            assert _records(t, rel) == _records(out, rel), rel
    # one shard of rows at the default rows_per_shard: the same rows
    want = [r for rel in _files(out, "url_cooc") for r in _records(out, rel)]
    assert _records(t, "url_cooc/part-00000.bz2") == want
    assert recordio.read_records(f"{t}/cooc/part-00000.bz2")
