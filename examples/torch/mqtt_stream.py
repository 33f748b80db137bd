"""Streaming tensors between two port pipelines over real MQTT.

The pipelines meet at an MQTT broker (the in-tree conformant MqttBroker
here; point ``broker=mqtt://host:port`` at mosquitto or any 3.1.1 broker
in production). Payloads carry the reference's 1 KB GstMQTTMessageHdr, so
a reference mqttsrc could subscribe to the same topic.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/mqtt_stream.py
"""

import time

from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.query.mqtt import MqttBroker


def main():
    broker = MqttBroker()  # 127.0.0.1, ephemeral port
    url = f"mqtt://127.0.0.1:{broker.port}"
    print(f"broker at {url}")

    receiver = parse_launch(
        f"tensor_pubsub_src broker={url} sub_topic=demo/frames "
        "num_buffers=5 ! tensor_sink name=out"
    )
    receiver.get("out").connect(
        lambda b: print(f"received {tuple(b.tensors[0].shape)} "
                        f"{b.tensors[0].dtype} pts={b.pts}"))
    receiver.start()
    time.sleep(0.3)  # let SUBSCRIBE land

    sender = parse_launch(
        "videotestsrc num-buffers=5 width=8 height=8 ! tensor_converter ! "
        f"tensor_pubsub_sink broker={url} pub_topic=demo/frames"
    )
    msg = sender.run(timeout=60)
    assert msg is not None and msg.kind == "eos", msg
    msg = receiver.wait(timeout=60)
    receiver.stop()
    broker.close()
    assert msg is not None and msg.kind == "eos", msg
    assert len(receiver.get("out").buffers) == 5, receiver.get("out").buffers


if __name__ == "__main__":
    main()
