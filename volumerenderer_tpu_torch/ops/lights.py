"""Light-model constants (twin of volumerenderer_tpu.ops.lights)."""

GUARD = 1e-4  # d^2 guard from common_functions.h:190
FOUR_PI = 4.0 * 3.14159265358979323846
