"""Host scene models: meshes, materials and the numpy scene compiler."""
