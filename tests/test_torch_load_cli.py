"""The port's CLI with `--device cpu` on the CPU, serving the `state/state.pt`
that the port's stage-2 `train()` wrote (LoRA merged at load): the streamed
reply equals a `ChatEngine`'s on the builder's model, which sits on the CPU
in bf16 as the CLI asks; without the flag the CLI asks for the card.
"""

import builtins
import os

import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from test_torch_train import _train_args, pil_fixture  # noqa: F401 — a fixture
from torch_port_util import jax_params_numpy, port_config, port_model, word_list, word_tokenizer
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu_torch.models import builder as tbuilder
from vis_zephyr_tpu_torch.serve import cli as tcli
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.train import checkpoints as tckpt

CFG = tiny_config()
TCFG = port_config(CFG)
WORDS = word_list(CFG.decoder.vocab_size)


def test_cli_device_cpu_serves_what_train_wrote(tmp_path, pil_fixture, monkeypatch, capsys):  # noqa: F811
    from PIL import Image

    from vis_zephyr_tpu_torch.train import train as ttrain

    data_path, img_dir = pil_fixture
    init = jax_params_numpy(CFG, 0)
    monkeypatch.setattr(ttrain, "init_vis_zephyr",
                        lambda cfg, generator, device, dtype: port_model(init, CFG).to(device, dtype))
    out = str(tmp_path / "run")
    args = ttrain.TrainArguments(**_train_args(ttrain, data_path, img_dir, out, stage="2",
                                               lora_r=4, lora_alpha=8, max_steps=1,
                                               num_epochs=1))
    ttrain.train(args, MockTokenizer(), cfg=TCFG)
    model_dir = tckpt.latest_checkpoint(out, full_state=True)
    assert os.path.exists(os.path.join(model_dir, "state", "state.pt"))
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        f.write(CFG.to_json())
    word_tokenizer(WORDS).save_pretrained(model_dir)

    tok, want_model, cfg, _ = tbuilder.load_pretrained_model(model_dir, device="cpu")
    assert want_model.device.type == "cpu" and want_model.dtype == torch.bfloat16
    image_file = os.path.join(img_dir, "img0.jpg")
    want = tengine.ChatEngine(want_model, cfg, tok, max_new_tokens=4).chat_text(
        "cli", "w5 w6 w7", pil_image=Image.open(image_file).convert("RGB"))

    turns = iter(["w5 w6 w7"])

    def answer(prompt=""):
        try:
            return next(turns)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr(builtins, "input", answer)
    tcli.main(["--model-path", model_dir, "--image-file", image_file, "--device", "cpu",
               "--max-new-tokens", "4"])
    assert f"assistant: {want}\n" in capsys.readouterr().out
    assert tcli.build_parser().parse_args(["--model-path", "m", "--image-file", "x"]).device == "cuda"
