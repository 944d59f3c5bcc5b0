"""The plain reference of a FedDD round: per-client SGD with ``F.conv2d``
and ``F.linear`` in float32 (TF32 off), Eq. (20)/(21) channel scores and
top-k masks, Eq. (4) aggregation, the Eq. (5)/(6) client update, and a
frozen copy of the Eq. (9)-(11) dropout-rate LP.  It imports nothing of
the program and takes nothing the program made: only the inputs
``perfbench.inputs`` hands to both sides."""
