"""Language-conditioned robot environment (LANRO-equivalent).

A copy of the JAX package's ``lanro/`` (numpy, and cv2 where a frame is
drawn), which the port does not import; it collects the same VILANRO data
and replays the port's trajectories in ``eval/vilanro_test.py``.

Capability-equivalent of the bundled lanro_gym simulator
(multimodal_compare/models/lanro_gym/, 3723 LoC over PyBullet): a
language-instructed tabletop manipulation environment used to (a) generate
the VILANRO trimodal dataset (image + instruction + action trajectory) and
(b) run closed-loop policy evaluation of trained multimodal VAEs.

PyBullet is not a dependency, so the default backend is a
*kinematic* simulation: end-effector dynamics are velocity-clamped
integration, grasping is proximity-based, and rendering is a top-down cv2
rasterizer.  The env API (make/reset/step/render, NL goal instructions,
success predicates) mirrors the reference's gym registration
(lanro_gym/__init__.py) so a PyBullet backend can be swapped in when the
dependency exists.
"""
from multimodal_vae_comparison_tpu_torch.lanro.env import ENV_REGISTRY, LanroEnv, make
