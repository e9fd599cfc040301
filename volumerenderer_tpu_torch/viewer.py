"""Interactive viewer (twin of volumerenderer_tpu.viewer): the reference's
ImGui panel and presentation (src/main.cpp:287-336, 639-705;
shaders/fullscreen.vert + sample_image.frag).

  * ``InteractiveViewer`` — a matplotlib window with the reference's
    controls (algorithm radio, parameter sliders, Refresh), refining the
    image progressively while idle.  Slider edits do not reset the
    accumulation; Refresh does, as in the reference (src/main.cpp:662-698).
  * ``render_offline`` — a headless progressive render to PNG or PPM.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .engine.params import Algorithm
from .engine.session import Renderer
from .io import ppm
from .utils.profiling import FrameStats


def render_offline(renderer: Renderer, frames: int,
                   out_path: str | None = None, callback=None) -> np.ndarray:
    """Accumulate ``frames`` frames; optionally write the result and call
    ``callback(frame_index, image)`` after each frame."""
    for i in range(frames):
        renderer.step()
        if callback is not None:
            callback(i + 1, renderer.image())
    img = renderer.image_u8()
    if out_path:
        if out_path.endswith(".ppm"):
            ppm.write_ppm(out_path, img)
        else:
            ppm.write_png(out_path, img)
    return img


class InteractiveViewer:
    """A matplotlib session (needs a display, or ``matplotlib.use("Agg")``
    to drive the wiring headless)."""

    # The ImGui panel's widgets, in the reference's order
    # (src/main.cpp:662-692): a SliderFloat3 becomes three component
    # sliders, the DragInt an integer-stepped slider.  Entries are
    # (field, lo, hi, kind), kind "f" float, "v3" vec3, "i" integer.
    SLIDERS = [
        ("camera_pos", -200.0, 200.0, "v3"),            # Camera Pos
        ("photon_initial_intensity", 0.0, 500.0, "f"),  # Photon Intensity
        ("scattering_probability", 0.0, 1.0, "f"),
        ("absorption_coefficient", 0.0, 1.0, "f"),
        ("max_lights", 0, 1_000_000, "i"),              # DragInt
        ("ray_max_distance", 0.0, 20000.0, "f"),
        ("ray_marching_step_size", 0.01, 10.0, "f"),
        ("light_source_world_pos", -100.0, 100.0, "v3"),
        ("beam_radius", 0.0, 10.0, "f"),
        ("light_ray_step_size", 0.01, 10.0, "f"),
    ]

    def __init__(self, renderer: Renderer, motion_mode: str | None = "coarse"):
        # The window is where camera drags happen, so it takes the coarse
        # motion path by default (StaticConfig.motion_mode); the Renderer's
        # own default stays "off".  None leaves the configuration alone.
        self.renderer = renderer
        if motion_mode is not None and renderer.config.motion_mode != motion_mode:
            renderer.config = dataclasses.replace(renderer.config,
                                                  motion_mode=motion_mode)
        # Frame 1 comes through the uncached step, before the view build.
        renderer.first_frame_uncached = True
        self.stats = FrameStats()
        self._build_ui()

    def _build_ui(self):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button, RadioButtons, Slider

        self.fig = plt.figure(figsize=(10, 7))
        self.ax_img = self.fig.add_axes([0.02, 0.05, 0.62, 0.9])
        self.ax_img.axis("off")
        self.im = self.ax_img.imshow(self.renderer.image(), vmin=0.0,
                                     vmax=1.0)
        self.fps_text = self.fig.text(0.02, 0.965, "", family="monospace",
                                      fontsize=9)

        self.ax_algo = self.fig.add_axes([0.68, 0.70, 0.28, 0.25])
        self.radio = RadioButtons(self.ax_algo, [a.name for a in Algorithm],
                                  active=int(self.renderer.algorithm))
        self.radio.on_clicked(self._on_algorithm)

        self.sliders = {}
        y, dy = 0.66, 0.032
        for name, lo, hi, kind in self.SLIDERS:
            if kind == "v3":
                cur = np.asarray(getattr(self.renderer.params, name),
                                 np.float32)
                for axis, label in enumerate("xyz"):
                    ax = self.fig.add_axes([0.72, y, 0.22, 0.02])
                    s = Slider(ax, f"{name}.{label}", lo, hi,
                               valinit=float(cur[axis]))
                    s.on_changed(self._make_vec3_setter(name, axis))
                    self.sliders[f"{name}.{label}"] = s
                    y -= dy
            else:
                ax = self.fig.add_axes([0.72, y, 0.22, 0.02])
                s = Slider(ax, name, lo, hi,
                           valinit=float(getattr(self.renderer.params, name)),
                           valstep=1 if kind == "i" else None)
                s.on_changed(self._make_param_setter(name))
                self.sliders[name] = s
                y -= dy
        ax_btn = self.fig.add_axes([0.72, y - 0.02, 0.22, 0.05])
        self.btn = Button(ax_btn, "Refresh")
        self.btn.on_clicked(lambda _ev: self.renderer.refresh())

    def _on_algorithm(self, label):
        self.renderer.set_algorithm(Algorithm[label])

    def _make_param_setter(self, name):
        def setter(value):
            # Slider edits change params only; the accumulation continues
            # until Refresh (src/main.cpp:662-698).
            self.renderer.set(**{name: value})

        return setter

    def _make_vec3_setter(self, name, axis):
        def setter(value):
            cur = np.asarray(getattr(self.renderer.params, name),
                             np.float32).copy()
            cur[axis] = value
            self.renderer.set(**{name: cur})

        return setter

    def tick(self, n: int = 1):
        """Advance ``n`` frames and update the image and the FPS readout."""
        self.renderer.step(n)
        # image() copies to the host, which waits for the frame: the
        # interval FrameStats sees is the frame's wall clock.
        self.im.set_data(self.renderer.image())
        for _ in range(n):
            self.stats.tick()
        cfg = self.renderer.config
        readout = (
            f"{self.stats.fps:6.1f} fps | "
            f"{self.stats.mrays_per_sec(cfg.width, cfg.height):7.1f} Mrays/s"
            f" | frame {int(self.renderer.state.frame_count)}"
        )
        self.fps_text.set_text(readout)
        manager = getattr(self.fig.canvas, "manager", None)
        if manager is not None:
            manager.set_window_title(f"volumerenderer_tpu_torch — {readout}")
        self.fig.canvas.draw_idle()

    def run(self, frames_per_tick: int = 1):
        """Blocking loop: render while the window is open."""
        import matplotlib.pyplot as plt

        plt.show(block=False)
        while plt.fignum_exists(self.fig.number):
            self.tick(frames_per_tick)
            plt.pause(0.001)
