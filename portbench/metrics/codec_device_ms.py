"""`codec_device_ms.<suffix>`: device milliseconds of the codec decode per
request (`models/genmodel.py::generate_audio`: RVQ decode and SEANet
decoder), from the CUDA events of the program's span `codec.decode`, over
the first traced pass (`harness/spans.py`). Moves the cell's serving
metric."""
from harness import spans


def read(view, suffix):
    return spans.per_item(view, spans.spans_sum(["codec.decode"],
                                                "device_ms"))
