"""The port's native C++ routes on the CPU: its copy of the BPE tokenizer
against an HF fast tokenizer, and its copy of the image pipeline against the
port's PIL host pipeline, with the tolerances of the JAX package's own tests
(`tests/test_tokenizer_native.py`, `tests/test_native.py`); and the port's
dataset taking `use_native` as the JAX dataset does.

Both libraries are built from `native/` into `vis_zephyr_tpu_torch/build/`
by `data/native_lib.py`; the tests skip, as the JAX ones do, where the
machine cannot build them (no `g++`, no libjpeg headers).
"""

import io
import json

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")
PIL = pytest.importorskip("PIL")

from PIL import Image  # noqa: E402
from tokenizers import Tokenizer, decoders, models, normalizers, trainers  # noqa: E402

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer  # noqa: E402
from vis_zephyr_tpu_torch.data import native, tokenizer_native  # noqa: E402
from vis_zephyr_tpu_torch.data.image_pipeline import anyres_preprocess_host  # noqa: E402

PINPOINTS = [(336, 672), (672, 336), (336, 1008), (1008, 336)]
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "hello world this is a test of the tokenizer",
    "describe the picture in detail please",
    "what is the answer to the question",
    "a b c d e f g h i j k l m n o p q r s t u v w x y z",
    "zephyr mistral vision language model training",
] * 50
CASES = [
    "the quick brown fox",
    "hello world",
    "zephyr model",
    "a",
    "",
    "   three leading spaces",
    "trailing spaces   ",
    "UNSEEN CAPITALS!?",          # byte fallback (capitals not in corpus)
    "héllo wörld",                # multi-byte UTF-8 → byte fallback
    "日本語のテキスト",              # CJK → byte fallback
    "emoji 🙂 test",
    "mixed 123 numbers and words",
    "the the the the the the",
]

needs_tokenizer = pytest.mark.skipif(not tokenizer_native.available(),
                                     reason="native tokenizer lib unavailable (no g++)")
needs_image = pytest.mark.skipif(not native.available(), reason="native image lib not built")


def llama_tokenizer_json(path) -> str:
    """A LLaMA-convention tokenizer.json (BPE + byte fallback, Prepend-▁ /
    Replace-space normalizers, the Zephyr-7B-β layout) trained on CORPUS."""
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    trainer = trainers.BpeTrainer(vocab_size=320, special_tokens=["<unk>", "<s>", "</s>"],
                                  show_progress=False)
    tok.train_from_iterator(CORPUS, trainer=trainer)
    tok.save(str(path))
    tj = json.loads(path.read_text())
    vocab = tj["model"]["vocab"]
    next_id = max(vocab.values()) + 1
    for b in range(256):  # the byte-fallback rows, as LLaMA lays them out
        name = f"<0x{b:02X}>"
        if name not in vocab:
            vocab[name] = next_id
            next_id += 1
    path.write_text(json.dumps(tj))
    return str(path)


@pytest.fixture(scope="module")
def tok_pair(tmp_path_factory):
    path = llama_tokenizer_json(tmp_path_factory.mktemp("tok") / "tokenizer.json")
    hf = Tokenizer.from_file(path)
    return hf, tokenizer_native.NativeTokenizer(blob=tokenizer_native.convert_tokenizer_json(path))


@needs_tokenizer
@pytest.mark.parametrize("text", CASES)
def test_encode_matches_hf(tok_pair, text):
    hf, tok = tok_pair
    assert tok.encode(text, add_bos=False) == hf.encode(text).ids


@needs_tokenizer
@pytest.mark.parametrize("text", CASES)
def test_decode_roundtrip_matches_hf(tok_pair, text):
    hf, tok = tok_pair
    ids = hf.encode(text).ids
    assert tok.decode(ids, skip_special_tokens=False) == hf.decode(ids)


@needs_tokenizer
def test_bos_vocab_and_call(tok_pair):
    hf, tok = tok_pair
    ids = tok.encode("hello", add_bos=True)
    assert ids[0] == tok.bos_token_id and tok("hello").input_ids == ids
    assert tok.vocab_size == hf.get_vocab_size()


@needs_tokenizer
def test_convert_ids_to_tokens_matches_hf(tok_pair):
    """The pieces read back from the binary are the tokenizer.json's, so the
    grammars' token strings (the JAX `token_strings_from_tokenizer`) are an
    HF tokenizer's: ``▁`` as a space and ``<0xNN>`` as one raw byte."""
    from vis_zephyr_tpu.serve.structured import token_strings_from_tokenizer

    hf, tok = tok_pair
    ids = list(range(hf.get_vocab_size()))
    assert tok.convert_ids_to_tokens(ids) == [hf.id_to_token(i) for i in ids]

    class HFPieces:
        def convert_ids_to_tokens(self, ids):
            return [hf.id_to_token(i) for i in ids]

    strings = token_strings_from_tokenizer(tok, len(ids))
    assert strings == token_strings_from_tokenizer(HFPieces(), len(ids))
    assert bytes([0xC3]) in strings and any(s.startswith(b" ") for s in strings)


# -- the image pipeline ----------------------------------------------------------------


@pytest.fixture
def image(rng):
    # Smooth-ish content so resamplers are comparable.
    base = rng.standard_normal((30, 40, 3))
    img = np.kron(base, np.ones((16, 16, 1)))  # 480x640 blocky
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img.astype(np.uint8)


@needs_image
def test_decode_jpeg_matches_pil(image):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=95)
    data = buf.getvalue()
    got = native.decode_jpeg(data)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert got.shape == ref.shape == image.shape
    # libjpeg IDCT implementations may differ by 1-2 levels.
    assert np.abs(got.astype(int) - ref.astype(int)).mean() < 1.5
    with pytest.raises(ValueError):
        native.decode_jpeg(b"not a jpeg")


@needs_image
@pytest.mark.parametrize("size", [(336, 336), (448, 336), (100, 200), "upscale"])
def test_resize_matches_pil_lanczos(image, size):
    if size == "upscale":
        image, size = image[:50, :50], (150, 100)
    got = native.resize_lanczos(image, size).astype(np.float64)
    ref = np.asarray(Image.fromarray(image).resize(size, Image.Resampling.LANCZOS)).astype(np.float64)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.mean() < 1.0, diff.mean()
    assert np.median(diff) <= 1.0


@needs_image
def test_anyres_matches_the_host_pipeline(image, rng):
    got_px, got_valid = native.anyres_preprocess_native(image, PINPOINTS)
    ref_px, ref_valid = anyres_preprocess_host(Image.fromarray(image), PINPOINTS)
    np.testing.assert_array_equal(got_valid, ref_valid)
    n = int(ref_valid.sum())
    diff = np.abs(got_px[:n] - ref_px[:n])
    assert diff.mean() < 0.02, diff.mean()  # normalized space; 1 uint8 level ≈ 0.015
    np.testing.assert_array_equal(got_px[n:], 0.0)
    wide = (rng.random((500, 2000, 3)) * 255).astype(np.uint8)
    assert native.anyres_preprocess_native(wide, PINPOINTS)[1].sum() == 4  # 3x1 tiles + global


# -- the dataset's route ---------------------------------------------------------------


@pytest.mark.parametrize("use_native", ["auto", "yes", "no"])
def test_dataset_takes_use_native_as_jax_does(tmp_path, use_native):
    """Any value but "no" takes the native route where the library builds,
    "no" always PIL, in both packages; the samples are the same."""
    from vis_zephyr_tpu.data import dataset as jdataset
    from vis_zephyr_tpu_torch.data import dataset as tdataset

    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 255, (90, 120, 3), np.uint8)).save(tmp_path / "a.jpg")
    record = {"id": "x-1", "image": "a.jpg", "conversations": [
        {"from": "human", "value": "<image>\nwhat is this"}, {"from": "gpt", "value": "a b"}]}
    (tmp_path / "data.json").write_text(json.dumps([record]))
    kw = dict(data_path=str(tmp_path / "data.json"), image_folder=str(tmp_path),
              mm_grid_pinpoints="[[56, 112], [112, 56], [56, 168], [168, 56]]", image_size=56,
              use_native=use_native)
    jds = jdataset.SupervisedDataset(jdataset.DataConfig(**kw), MockTokenizer())
    tds = tdataset.SupervisedDataset(tdataset.DataConfig(**kw), MockTokenizer())
    assert tds._use_native == jds._use_native == (use_native != "no" and native.available())
    want, got = jds[0], tds[0]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
