"""The port's visual prompting (`vis_zephyr_tpu_torch/data/vip`) against the
JAX package's, on the CPU.

Each of the eight shapes blended by `blend_shape` gives the same pixels for
the same `random.Random` seed; the geometry and text helpers give the same
values and leave the generator in the same state; `visual_prompt_process`
gives the same conversations and image bytes in the `vcr_qa`, `vcr_qar` and
train styles; and the port's `SupervisedDataset` serves a VCR record (the
ViP route, seeded per item) exactly as the JAX dataset does. The records are
synthetic (`torch_port_util.vcr_records`): a seeded PNG, a `meta_dir` JSON
with boxes and polygon masks, questions and choices; nothing is downloaded.
"""

import json
import random

import numpy as np
import pytest
from PIL import Image

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from torch_port_util import vcr_records
from vis_zephyr_tpu.data import dataset as jdataset
from vis_zephyr_tpu.data.vip import draw as jdraw
from vis_zephyr_tpu.data.vip import geometry as jgeo
from vis_zephyr_tpu.data.vip import processor as jproc
from vis_zephyr_tpu.data.vip import text as jtext
from vis_zephyr_tpu.data.vip.config import COLOR_POOL
from vis_zephyr_tpu_torch.data import dataset as tdataset
from vis_zephyr_tpu_torch.data.vip import draw as tdraw
from vis_zephyr_tpu_torch.data.vip import geometry as tgeo
from vis_zephyr_tpu_torch.data.vip import processor as tproc
from vis_zephyr_tpu_torch.data.vip import text as ttext

SHAPES = ["rectangle", "ellipse", "arrow", "triangle", "point", "scribble", "mask contour",
          "mask"]
PINPOINTS = "[[56, 112], [112, 56], [56, 168], [168, 56]]"


@pytest.fixture(scope="module")
def vcr(tmp_path_factory):
    return vcr_records(tmp_path_factory.mktemp("vcr"), 3, seed=0)


def both(fn_j, fn_t, *args, seed=0, **kw):
    """Each package's function on the same arguments and a fresh generator
    of `seed`; the two results and the generators' next draws."""
    out = []
    for fn in (fn_j, fn_t):
        rng = random.Random(seed)
        out.append((fn(*args, rng, **kw), rng.random()))
    return out


@pytest.mark.parametrize("line_style", [None, "constant"])
@pytest.mark.parametrize("shape", SHAPES)
def test_blend_shape_pixels_match(shape, line_style):
    img = Image.fromarray(np.random.default_rng(1).integers(0, 255, (90, 130, 3), np.uint8))
    segs = [[30, 20, 90, 25, 85, 70, 35, 60], [95, 10, 120, 10, 120, 40]]
    for seed in range(3):
        outs = []
        for mod in (jdraw, tdraw):
            rng = random.Random(seed)
            out = mod.blend_shape(img, shape, (30, 20, 90, 70), segs if seed != 2 else None,
                                  (255, 165, 0), rng, image_size_anchor=56,
                                  line_style=line_style)
            outs.append((np.asarray(out), rng.random()))
        np.testing.assert_array_equal(outs[1][0], outs[0][0], err_msg=f"{shape} seed {seed}")
        assert outs[1][1] == outs[0][1]
        assert not np.array_equal(outs[1][0], np.asarray(img))  # something was drawn


def test_geometry_matches():
    flat = [[0, 0, 40, 0, 40, 30, 0, 30], [50, 50, 70, 50, 60, 80]]
    jp, tp = jgeo.PolygonSet.from_flat(flat), tgeo.PolygonSet.from_flat(flat)
    assert tp.bounds == jp.bounds and len(tp) == len(jp) == 2
    assert tp.single(1).bounds == jp.single(1).bounds
    pts = np.random.default_rng(0).uniform(-5, 85, (64, 2))
    assert ([tp.contains(x, y) for x, y in pts] == [jp.contains(x, y) for x, y in pts])
    square = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], float)
    assert ([tgeo.point_in_polygon(x, y, square) for x, y in pts]
            == [jgeo.point_in_polygon(x, y, square) for x, y in pts])
    for seed in range(4):
        j, t = both(jgeo.gaussian_point, tgeo.gaussian_point, jp.bounds, seed=seed)
        assert t == j
        j, t = both(lambda r: jgeo.gaussian_point_in_polygon(jp, jp.bounds, r),
                    lambda r: tgeo.gaussian_point_in_polygon(tp, tp.bounds, r), seed=seed)
        assert t == j
        j, t = both(lambda r: jgeo.uniform_point_in_polygon(jp.single(1), r),
                    lambda r: tgeo.uniform_point_in_polygon(tp.single(1), r), seed=seed)
        assert t == j
        j, t = both(jgeo.uniform_point_in_bbox, tgeo.uniform_point_in_bbox, (1, 2, 30, 40),
                    seed=seed)
        assert t == j
    for tri in ([(0, 0), (10, 0), (5, 8)], [(0, 0), (10, 0), (5, 0.1)], [(1, 1), (1, 1), (3, 4)]):
        assert tgeo.max_angle_below(tri) == jgeo.max_angle_below(tri)
    np.testing.assert_array_equal(tgeo.cubic_bezier((0, 0), (1, 2), (3, 4), (10, 10), num=77),
                                  jgeo.cubic_bezier((0, 0), (1, 2), (3, 4), (10, 10), num=77))


def test_text_matches():
    corpora = [["Why", "is", [0, 2], "smiling", "?"], [[1], "and", [0], "walk", "."],
               [[3], "holds", [2, 1], ","]]
    assert ttext.collect_entity_indices(corpora) == jtext.collect_entity_indices(corpora)
    entities = ttext.collect_entity_indices(corpora) + list(range(4, 12))
    colors = list(COLOR_POOL.items())
    for seed in range(6):
        for shapes in (("rectangle",), ("point",), ("rectangle", "ellipse", "arrow", "mask")):
            j, t = both(lambda r: jtext.assign_shapes_and_colors(entities, shapes, colors, r),
                        lambda r: ttext.assign_shapes_and_colors(entities, shapes, colors, r),
                        seed=seed)
            assert t == j
        assignments = j[0]
        for names, kind in ((None, ""), (["person", "dog", "car", "bike"], ""),
                            (["person", "dog", "car", "bike"], "direct")):
            j, t = both(lambda r: jtext.rewrite_entity_tags(corpora, assignments, names, r, kind),
                        lambda r: ttext.rewrite_entity_tags(corpora, assignments, names, r, kind),
                        seed=seed)
            assert t == j
        options = ["a cat", "b dog", "c", "d"]
        for mc, why, no_image in ((True, False, False), (False, False, True), (True, True, False)):
            j, t = both(lambda r: jtext.build_question("What is it?", options, mc, r, why, no_image),
                        lambda r: ttext.build_question("What is it?", options, mc, r, why, no_image),
                        seed=seed)
            assert t == j
        for idx in range(4):
            j, t = both(lambda r: jtext.build_answer(idx, "Some content here", seed % 2 == 0, r),
                        lambda r: ttext.build_answer(idx, "Some content here", seed % 2 == 0, r),
                        seed=seed)
            assert t == j
    assert (ttext.multiple_choice_block("Q?", ["a", "b", "c", "d"])
            == jtext.multiple_choice_block("Q?", ["a", "b", "c", "d"]))
    with pytest.raises(ValueError):
        ttext.multiple_choice_block("Q?", ["a"])


@pytest.mark.parametrize("style", ["vcr_qa", "vcr_qar", None])
def test_visual_prompt_process_matches(vcr, style):
    records, folder = vcr
    for i, rec in enumerate(records):
        image = Image.open(f"{folder}/{rec['image']}").convert("RGB")
        outs = []
        for mod in (jproc, tproc):
            rng = random.Random(10 + i)
            out_img, convs = mod.visual_prompt_process(rec, image, image_size_anchor=56,
                                                       image_folder=folder,
                                                       visual_prompt_style=style, rng=rng)
            outs.append((out_img.tobytes(), out_img.size, convs, rng.random()))
        assert outs[1] == outs[0], (style, i)
        assert len(outs[1][2]) == (4 if style is None else 2)
        assert outs[1][0] != image.tobytes()  # the overlay drew
    assert tproc.supports("vcr-val-0") and not tproc.supports("coco-1") and not tproc.supports(3)
    with pytest.raises(NotImplementedError):
        tproc.visual_prompt_process({"id": "refcocog-train-1"}, image, rng=random.Random(0))


def _datasets(tmp_path, records, folder, style, vip_processor=None):
    path = tmp_path / "records.json"
    path.write_text(json.dumps(records))
    out = []
    for mod in (jdataset, tdataset):
        cfg = mod.DataConfig(data_path=str(path), image_folder=folder, mm_grid_pinpoints=PINPOINTS,
                             image_size=56, visual_prompt_style=style, seed=3, use_native="no")
        out.append(mod.SupervisedDataset(cfg, MockTokenizer(), vip_processor=vip_processor))
    return out


@pytest.mark.parametrize("style", [None, "vcr_qa"])
def test_dataset_serves_vcr_records_as_jax(tmp_path, vcr, style):
    """A raw VCR record (no "conversations") through the ViP route with the
    per-item generator `f"{seed}-{index}"`, beside a plain captioned record:
    input_ids, labels, pixels, patch_valid and the image size equal."""
    records, folder = vcr
    plain = {"id": "coco-1", "image": records[0]["image"],
             "conversations": [{"from": "human", "value": "<image>\ndescribe it"},
                               {"from": "gpt", "value": "a picture"}]}
    jds, tds = _datasets(tmp_path, records + [plain], folder, style)
    assert tds.lengths == jds.lengths and tds.modality_lengths == jds.modality_lengths
    for i in range(len(records) + 1):
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        for key in ("input_ids", "labels", "images", "patch_valid"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} of record {i}")
        assert got["images_size"] == want["images_size"]
    assert tds._vip_rng(1).random() == jds._vip_rng(1).random()


def test_dataset_takes_a_vip_processor(tmp_path, vcr):
    """A `vip_processor` replaces the ViP route for records with a string id,
    in both packages alike."""
    records, folder = vcr

    def processor(rec, image):
        return image.transpose(Image.FLIP_LEFT_RIGHT), [
            {"from": "human", "value": "<image>\nwhich one " + rec["id"]},
            {"from": "gpt", "value": "B"}]

    jds, tds = _datasets(tmp_path, records[:1], folder, None, vip_processor=processor)
    want, got = jds[0], tds[0]
    for key in ("input_ids", "labels", "images", "patch_valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
