"""Model files on the port: a ``.py`` with ``get_model()``, the JAX
package's ``.msgpack`` weights with ``custom=module:<factory>``, and
``--export`` of either to a self-contained ``.pt2``.

The reference's core workflow is "point tensor_filter at an opaque model
file". On the port that file is a ``torch.export`` program (``.pt2``):
weights inside, caps from its signature, loaded by extension with
framework=auto; the batch dimension is exported dynamic, so the same
file serves under ``mesh=``.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/artifact.py
"""

import os
import tempfile

import numpy as np
import torch

from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.cli import main as nns_launch
from nnstreamer_tpu_torch.filters.artifact import export_model
from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    mobilenet_v2,
    params_to_jax,
)
from nnstreamer_tpu_torch.single import SingleShot
from nnstreamer_tpu_torch.utils.checkpoint import save_params


def _host(x):
    """An output as a numpy array (a tensor on the card comes back)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def main():
    workdir = tempfile.mkdtemp(prefix="nnstpu_artifact_")

    # 1. author a model the usual way (a .py with get_model()) ...
    model_py = os.path.join(workdir, "edge_detect.py")
    with open(model_py, "w") as f:
        f.write(
            "import torch\n"
            "from nnstreamer_tpu_torch.tensors.types import TensorsInfo\n"
            "IN_INFO = TensorsInfo.from_str('3:8:8:1', 'float32')\n"
            "def get_model():\n"
            "    def fn(x):\n"
            "        gx = torch.abs(torch.diff(x, dim=2)).mean(dim=(1, 2, 3))\n"
            "        return gx\n"
            "    return fn\n"
        )

    # 2. ... export it to a self-contained artifact (weights baked in;
    # equivalently: nns-launch-torch --export edge_detect.py edge.pt2)
    artifact = os.path.join(workdir, "edge.pt2")
    out_info = export_model(model_py, artifact)
    print(f"exported {artifact} (outputs: {out_info})")

    # 3. the artifact is now an opaque file: any pipeline or SingleShot
    # loads it by extension, caps come from the program's signature
    with SingleShot(model=artifact) as s:
        print("input info:", s.get_input_info())
        (y,) = s.invoke([np.ones((1, 8, 8, 3), np.float32)])
        print("singleshot result:", _host(y))

    pipe = parse_launch(
        "videotestsrc num-buffers=4 width=8 height=8 ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! "
        f"tensor_filter model={artifact} ! tensor_sink name=out"
    )
    pipe.get("out").connect(
        lambda b: print("edge energy:", float(_host(b[0])[0])))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg

    # 4. weights the JAX package wrote with utils.checkpoint.save_params
    # (flax msgpack) load by name with custom=module:<factory>; the
    # factory's arguments follow the file's shapes. Here the port writes
    # such a file itself, for a narrow MobileNetV2.
    weights = os.path.join(workdir, "mnv2.msgpack")
    module, _, _ = mobilenet_v2(num_classes=10, width=0.35, image_size=96)
    save_params(params_to_jax(module), weights)
    # the factory declares 224×224 frames: input= gives these frames' size
    pipe = parse_launch(
        "videotestsrc num-buffers=4 width=96 height=96 pattern=ball ! "
        "tensor_converter ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        f"tensor_filter framework=jax model={weights} "
        "custom=module:mobilenet_v2 input=3:96:96:1 inputtype=float32 ! "
        "tensor_decoder mode=image_labeling ! tensor_sink name=out"
    )
    pipe.get("out").connect(
        lambda b: print(f"msgpack label_index={b.meta['label_index']} "
                        f"score={b.meta['score']:.4f}"))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg

    # 5. and --export takes the .msgpack too
    exported = os.path.join(workdir, "mnv2.pt2")
    rc = nns_launch(["--export", weights, exported,
                     "--custom", "module:mobilenet_v2",
                     "--input", "3:96:96:1"])
    assert rc == 0, f"--export of the .msgpack: rc={rc}"
    print(f"--export of the .msgpack: rc={rc}")


if __name__ == "__main__":
    main()
