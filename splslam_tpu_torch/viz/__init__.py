"""Visualization (port of splslam_tpu/viz): the reference's Pangolin
Viewer/FrameDrawer/MapDrawer (src/Viewer.cc, FrameDrawer.cc,
MapDrawer.cc) as headless renderers (`draw`) plus a live background render
loop (`Viewer`) that imshows when a display exists and records PNG frames
otherwise. Host numpy + OpenCV/matplotlib, imported where they draw."""

from splslam_tpu_torch.viz.draw import draw_frame, plot_map  # noqa: F401
from splslam_tpu_torch.viz.viewer import Viewer  # noqa: F401
