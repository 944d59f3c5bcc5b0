"""Client-batched SAME convolutions for vmapped local SGD
(``csrc/conv.cu``): ``ops.conv2d_same``, its passes and their plain
versions (``ref.py``)."""
