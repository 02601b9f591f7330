"""Scene recipes, one module a recipe, found by the name a configuration
gives under ``recipe``.  Each has ``describe(args) -> dict``: the scene as
plain data (materials, spheres, quads, meshes with their model matrix),
which the program's scene builder and the reference each build."""
