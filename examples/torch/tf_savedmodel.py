"""TensorFlow SavedModel on the port: point the filter at the directory.
It runs only where ``tensorflow`` is importable, and then on the host
(ROADMAP C.46): the TF backend serves the graph with TensorFlow on the
CPU, as the reference's tensor_filter_tensorflow does.

The pipeline around it runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on
the CPU.
Run: python examples/torch/tf_savedmodel.py   (requires tensorflow)
"""

import os
import tempfile

import numpy as np

from nnstreamer_tpu_torch import parse_launch


def build_saved_model(path: str):
    import tensorflow as tf

    class Classifier(tf.Module):
        """Toy 'vision model': per-channel means as 3 class scores."""

        @tf.function(input_signature=[
            tf.TensorSpec([1, 32, 32, 3], tf.uint8)])
        def __call__(self, x):
            xf = tf.cast(x, tf.float32) / 255.0
            return {"scores": tf.reduce_mean(xf, axis=[1, 2])}

    tf.saved_model.save(Classifier(), path)
    return path


def main():
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        print("tensorflow not importable — export the model to a .pt2 "
              "(nns-launch-torch --export) and load that instead")
        return

    sm = build_saved_model(
        os.path.join(tempfile.mkdtemp(), "classifier_sm"))

    pipe = parse_launch(
        "videotestsrc num-buffers=4 width=32 height=32 pattern=smpte ! "
        "tensor_converter ! "
        f"tensor_filter framework=tensorflow model={sm} name=net ! "
        "tensor_sink name=out")
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    for i, buf in enumerate(pipe.get("out").buffers):
        scores = np.asarray(buf.tensors[0])[0]
        print(f"frame {i}: channel scores = "
              f"{np.array2string(scores, precision=3)}")
    print(f"invoke latency: {pipe.get('net').get_property('latency')} us")


if __name__ == "__main__":
    main()
