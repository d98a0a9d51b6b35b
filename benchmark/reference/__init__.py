"""The plain reference: RetinaNet's forward, its training step and its
detection postprocess in plain PyTorch, fp32 with TF32 off.

Written from the published description (Lin et al., arXiv:1708.02002;
Detectron's ``retinanet_R-{50,101}-FPN_1x``) and the configuration files
under ``benchmark/configs``. It imports nothing of the program under test
and takes nothing the program made: the benchmark hands both sides the
same weights and inputs, and the reference works out anchors, matching,
losses, the optimizer's state and the detections again from those.
"""
