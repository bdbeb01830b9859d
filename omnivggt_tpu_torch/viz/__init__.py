"""Scene outputs: the GLB export, sky masks, scene meshes and the viewer."""
