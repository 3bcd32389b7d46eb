"""Small sizes of the cells for the CPU tests."""

from sam_bench import spec

# the configurations' views a point: 4, and 5 for about a third of the points
SIZES = {
    "ladybug-1723": dict(n_cameras=20, n_points=500, n_observations=2168),
    "ladybug-1723-cut750": dict(n_cameras=20, n_points=500, n_observations=2168),
}


def small_cell(name: str, **over) -> spec.Cell:
    cell = spec.cell(spec.benchmark(), name)
    cell.config.update(SIZES[cell.config_name])
    cell.config.update(over)
    return cell
