from .renderer import RenderOutputs, render_views
from .conditioning import (
    render_geometry_condition,
    views_to_grid,
    grid_to_views,
    grid_to_strip,
    strip_to_grid,
)
from .field_vis import create_grid, marching_tetrahedra, export_isosurface
