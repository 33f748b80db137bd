"""Audio keyword spotting on the port: audiotestsrc → window → classify.

The audio peer of classify.py — the same converter/filter/decoder
contract over an audio stream (the int16 → float32 scaling is kernel B1).

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/audio.py
"""

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model
from nnstreamer_tpu_torch.models.audio_classifier import audio_classifier

SAMPLES = 8000  # 0.5 s window @ 16 kHz

register_torch_model("kws", *audio_classifier(samples=SAMPLES,
                                              num_classes=12))

pipe = nt.parse_launch(
    f"audiotestsrc num-buffers=8 samplesperbuffer={SAMPLES} ! "
    f"tensor_converter frames-per-tensor={SAMPLES} ! "
    "tensor_transform mode=arithmetic option=typecast:float32,div:32768 ! "
    "tensor_filter framework=jax model=kws name=f ! "
    "tensor_decoder mode=image_labeling ! "
    "tensor_sink name=out to-host=true")

labels = []
pipe.get("out").connect(lambda b: labels.append(b.meta["label_index"]))
msg = pipe.run(timeout=300)
assert msg is not None and msg.kind == "eos", msg
print(f"classified {len(labels)} windows; labels: {labels}")
print(f"filter latency: {pipe.get('f').get_property('latency')} µs")
