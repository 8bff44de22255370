"""On-card smoke test of the PyTorch/CUDA port (eradiate_kernel_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. build every CUDA kernel of the port (tile_sweep, tile_bvh, tile_bvh8,
     grid_gather) from the repository's sources, one nvcc per source, in
     parallel, printing each kernel's registers and spills and a few
     instruction counts of its SASS; then the host libraries with g++
     (the tile and BVH builders, and the OpenEXR bridge where libOpenEXR
     is installed);
  2. hold the tile-sweep kernel against its plain PyTorch version on the
     bench terrain (terrain(256): 130,050 triangles, 1,017 tiles: the
     sorted pipeline) with 2^20 coherent primary rays and 2^20 incoherent
     rays;
  3. render the terrain scene at full width (256x256 film, 16 spp, path
     tracer with max_depth 6, RPV surface, directional sun) through the
     port's ``load_dict`` and ``integrators.render``, counting kernel
     launches;
  4. render a 64x64, 4 spp version (max_depth 3; 6 until phase 40 was
     added) twice, through the kernel and through
     the plain sweep, and compare the films;
  5. hold each tile-BVH kernel (binary and 8-wide, walking in warps of
     ops/intersect.py's BVH_GROUP = 32 rays) against its plain version,
     bit for bit, visit counts included: terrain(256) through the BVH with
     the loads of phase 2, and the instanced forest (bench_mesh.py's
     bench_forest: one 2,048-triangle crown instanced 256 times, 4,096 BVH
     leaves) with 2^19 primary rays;
  6. render the forest at full width (256x256, 16 spp, max_depth 6, RPV
     ground, directional sun) through the binary BVH (the default policy)
     and through the 8-wide BVH (ERT_BVH_WIDE=1), counting launches; then
     once more with every launch synchronised and timed (the kernel stage:
     ms a launch) and its visits summed for the bound;
  7. render a 64x64, 4 spp, max_depth 2 forest (depth cut from 6 for the
     time limit) through each BVH kernel and its plain version and compare
     the films;
  8. hold the row-gather kernel's gather entry against its plain version,
     bit for bit: on the gather probe's shape (4,096 rows of 1 float, 1,024
     lanes) and on the packed 8-corner table of a 64^3 grid with 32,768
     lanes of corner indices of random points, with the wrapper's host time
     piece by piece; then its fused trilinear entry against the plain chain
     on the 64^3 load, timed beside torch's grid_sample on the same grid;
  9. render the atmosphere (utils/scenes.atmosphere, bench.py's flagship
     load: 256x256 film, 64 spp, volpath max_depth 12, a 64 x 4 x 4
     plane-parallel grid, residual NEE transmittance) on the regenerating
     lane pool of 32,768 lanes, counting kernel launches (tile_sweep ==
     closest-hit queries: the atmosphere cube is one tile, one fused
     launch a query), loop iterations and host syncs;
 10. render the atmosphere with a 64^3 grid (bench.py's large3d) at 4 spp
     (bench.py: 64; cut for the time limit) the same way; grid_gather launches == gridvolume lookups > 0 (one
     fused launch a lookup); then the fused query on the cube (32,768
     rays) and on an 8-tile terrain(23) against its plain version, bit for
     bit, timed beside the eager sorted pipeline; and the fused query
     against the sorted pipeline on 8-, 16- and 32-tile terrains under
     2^15 and 2^20 primary and incoherent rays (where the sort starts to
     pay);
 11. render a 64x64, 4 spp, max_depth 6 (12 until phase 39 was added)
     64^3 atmosphere through the kernels, through the plain gather and
     through the plain sweep, and compare the films;
 13. hold the trilinear lookup's backward entry (grid_trilinear_bwd)
     against its plain version on phase 8's 64^3 load (32,768 lanes of
     random points, C = 1, 3 and 8) within rtol 1e-5 and atol 1e-7 (its
     atomics add in an order that changes from run to run), and bit for
     bit on 32,768 lanes whose corners no two lanes share; timed beside
     the plain index_add_ chain and the backward of grid_sample; the
     share of lanes whose corner row another lane of their warp shares
     (what the kernel's warp aggregation merges), and the wrapper's host
     time piece by piece (C = 1);
 13b. (after phase 38) the same entry on the adjoint's own lanes: the
     grid_trilinear_bwd call with the most lanes of phase 14's 64^3
     value+grad (C = 1) and of phase 37c's (C = 8), captured by wrapping
     gather.grid_trilinear_bwd for the duration, in float32 and float64
     against the plain version (rtol 1e-5, atol 1e-7; float64 1e-12,
     1e-15), with their shares of shared rows and device times;
 14. value+grad (the mean of the developed image with respect to the
     gridvolume grid, the albedo and the spectra, the sun's irradiance
     among them) of the flagship and of the 64^3 atmosphere at 256x256,
     spp 2, max_depth 6 (cut from spp 4 and max_depth 12 for the time
     limit),
     through autodiff.traverse, integrators.render(regen=True) and
     loss.backward() (the lane pool's path-replay backward): primal and
     value+grad times, forward and adjoint loop iterations, host syncs,
     launches of every kernel and entry in the forward and in the
     backward (grid_trilinear_bwd launches == gridvolume lookups of the
     adjoint > 0 on the 64^3 scene), threefry's share (``ert::rng``) of a
     profiled flagship value+grad's busy device time, and the peak device
     memory; the film bit-equal to the primal render's, the gradients
     finite and not all zero; then
     the 64x64 spp4 max_depth 6 value+grad of the 64^3 atmosphere
     through the kernels
     and through the plain gather and the plain sweep, gradients within
     phase 13's tolerance;
 15. render the Cornell box (utils/scenes.cornell_box(256, 256, spp=32,
     max_depth=6): 2,097,152 samples; spp 64, as the flagship, until phase
     37 was added) on the lane pool of
     32,768 lanes through render(regen=True): time, Msamples/s, loop
     iterations and host syncs (the pool's own, counted where it syncs,
     and the path tracer's bounce gates); its six rectangles launch no
     kernel; then a
     64x64 spp4 Cornell box through the pool and the scan driver, films
     compared;
 16. the analytic gates on the card: a constant environment of 0.7
     renders 0.7 (scan driver and pool), furnace(0.5, 1.0)'s centre pixels
     0.5 within tests/test_render.py's 0.02, and the volumetric scattering
     furnace (albedo 1 under a constant environment) L = 1 within
     tests/test_volpath.py's figures;
 17. the terrain render (phase 3's scene) on the lane pool of 2^18 lanes
     through render(regen=True): tile_sweep launches == closest-hit
     queries, and its film against the scan driver's (budget 64 pixels:
     the scan splats 12 samples into the next pixel, phase 35c);
 18. the forest render (phase 6's scene) on the same pool through
     tile_bvh and tile_bvh8: launches == closest-hit queries;
 19. value+grad through the path replay of terrain(256) and the forest at
     256x256, spp 2 (the primal phases take 16; cut for the time limit,
     from 4 when phase 35 was added):
     d(mean image)/d(spectra.baked.value), its sun's row and the crown's
     diffuse reflectance row compared finite and not zero (the RPV rows
     are NaN in the reference too), forward and adjoint launches (one a
     closest-hit query), iterations, host syncs, peak memory, value+grad
     time against the primal's, the film bit-equal to the primal's; then
     at 32x32 spp2 max_depth 2 (depth cut for the plain walks' time; 64x64
     until phase 39 was added, spp 4 and max_depth 3 until phase 37 was)
     the gradients through the sweep on terrain(64) and through tile_bvh
     and tile_bvh8 on a forest of 64 instances (terrain(256) and 256
     instances until phase 41 was added) against their plain versions (rtol 1e-5, atol 1e-7), the kernel legs launching
     their kernel once a query and the plain legs nothing;
 20. the flagship atmosphere at 128x128 (256x256 until phase 39 was
     added), spp 4, under a constant sky
     (radiance 0.1, added to the dict here), which runs volpath's MIS
     emitter walk, on the lane pool of 32,768 lanes: tile_sweep launches
     == closest-hit queries; then a 64x64 spp4 film through the kernel
     against the plain sweep's;
 21. Eradiate's 1D atmosphere under distant sensors (slice 5b): the
     flagship's atmosphere (grid 64, max_depth 12, residual NEE) under
     utils.scenes.atmosphere(sensor="distant"), a 1x1 film of 65,536
     samples (a quarter of bench.py's distant load since phase 39 was
     added) in the mono variant, then under an mdistant of 128 view
     zeniths in [-75, 75] degrees in the sun's principal plane (512 spp
     each), then the 1x1 film in rgb, all on
     the lane pool of 32,768 lanes: time, Msamples/s, iterations, syncs,
     tile_sweep launches == closest-hit queries;
 22. the single-scattering closed form (tests/test_single_scattering_
     oracle.py's four cases, its formula copied here) through a 1x1
     distant at max_depth 2, 4 seeds of 16,384 samples (65,536 until
     phase 39 was added, 262,144 until phase 37 was), gated at
     |mean - closed form| < 4 sigma + 0.005 expected;
 23. the sensors' analytic gates under a constant environment (spp
     4,096): distant single, plane and hemisphere, mdistant and
     mradiancemeter read 0.7 within 1e-3, a slanted cross-section distant
     0.7 / 0.8, distantflux sums to pi within 1 %, irradiancemeter reads
     pi within 2 %; and a bilambertian plane (r 0.6, t 0.4) under a sky of
     1 reads 1 within 0.01;
 24. the forest's BRF: the forest under a distant sensor (64x64
     hemisphere, point target at the canopy), spp 64, path max_depth 6,
     on a pool of 2^18 lanes through tile_bvh and tile_bvh8 (launches ==
     queries); and each BVH kernel against its plain walk on the 2^18
     parallel rays of a nadir distant sensor, bit for bit;
 25. the reference's default filter: terrain(256) at 256x256 spp16
     max_depth 6 with no rfilter (gaussian, radius 2) through the scan
     driver and the pool of 2^18 lanes (films within 64 pixels), the
     splat's share (``ert::film``) of a profiled pool render's busy device
     time, value+grad at spp 4
     through the path replay (launches == queries), and film_put and
     film_gather on 2^20 random samples into 256x256 against the same
     call on the CPU (rtol 1e-5), timed beside the bound and an
     index_put_ splat;
 26. the materials Cornell box (slice 5c-1): utils.scenes.cornell_box at
     256x256, spp 2 (phase 15's box takes 32; cut for the time limit,
     from 16 when phase 35 was added, from 8 when phase 37 was, from 4
     when phase 39 was),
     max_depth 6, with a dielectric, a rough gold and a rough dielectric
     sphere, a 12-triangle cube mesh (one tile: the fused query) under a
     Beckmann rough plastic with a checkerboard, the back wall under a
     bump map and the floor under a normal map (inline 64x64 bitmaps), on
     the lane pool of 32,768 lanes: time, Msamples/s, iterations, host
     syncs, tile_sweep launches == closest-hit queries; a 64x64 spp2
     max_depth 3 film (spp 4 until phase 37 was added, max_depth 6 until
     phase 39 was) through the kernel against the
     plain sweep (budget 2); value+grad at
     128x128 spp 1 (256x256 until phase 39 was added, spp 2 until phase
     37 was) through the path replay
     (the checkerboard's colours,
     the gold's eta and k and the walls' reflectances finite and not
     zero, the film bit-equal to the primal's, forward and adjoint
     launches == queries, peak memory); the 64x64 spp2 max_depth 3
     gradient through the kernel against the plain sweep (rtol 1e-5,
     atol 1e-7);
 27. the materials terrain(256) (the sorted sweep): uvs, a per-vertex
     colour and a blendbsdf (checkerboard weight) over a plastic and an
     anisotropic Beckmann rough conductor, 256x256 spp16 max_depth 6
     through the scan driver and a pool of 2^18 lanes (launches ==
     queries, films within phase 17's 64 pixels), and a 64x64 spp4
     max_depth 2 film (6 until phase 39 was added, 3 until phase 40 was)
     through the kernel against the plain sweep (budget 2);
 28. tests/test_bsdfs.py's furnace gates (the conductor mirror, the
     dielectric, the thin dielectric, the rough dielectric at alpha 0.02,
     the blend of diffuse and conductor, a flat normal map, the mask's
     pass-through rectangle) at 32x32 spp 256 with each test's max_depth
     and rr_depth, on the lane pool, each held to its test's tolerance;
 29. mesh files (slice 5c-2): terrain(256) written as PLY (utils.meshio.
     write_ply), OBJ and Mitsuba serialized (this script's write_obj and
     write_serialized) under smoke_out/mesh_files, each loaded through
     load_dict (host seconds printed): its arrays bit-equal to the inline
     mesh scene's (an OBJ's vertex numbering aside: the same triangles
     and tiles) and its 256x256 spp16 max_depth 6 film through the sorted
     sweep bit-equal to phase 3's, launches == queries; the forest with
     its crown read from an OBJ shapegroup child (to_world scale 0.5):
     tiles and BVHs bit-equal to the inline crown's, 64x64 spp4 max_depth
     2 films through tile_bvh and tile_bvh8 bit-equal to the inline
     forest's, launches == queries;
 30. the measured ground under an envmap sky: terrain(256) from the PLY
     under a measured BRDF (fields in the layout of tests/test_measured.py's
     synth_fields, T = 6, L = 16, res = 32, from the seed), a 256 x 512
     envmap (a smooth sky and a one-texel sun 10^4 times it) and the
     multijitter sampler; 256x256 spp8 (16 until phase 37 was added)
     max_depth 6 on the scan driver
     and a pool of 2^18 lanes (launches == queries, films within 64
     pixels); a 64x64 spp4 max_depth 2 film (6 until phase 39 was added,
     3 until phase 40 was) through the kernel against the plain sweep
     (budget 2); value+grad at
     spp 2 (4 until phase 37 was added)
     with respect to the envmap's
     image and the measured spectra (finite, not zero; launches ==
     queries), and at 64x64 spp4 max_depth 2 (depth cut for the plain
     sweep's time, as phase 19; 3 until phase 39 was added) through the
     kernel against the plain
     sweep (rtol 1e-5, atol 1e-7);
 31. the lights-and-quadrics box: cornell_box(256, 256, 2, 6) (spp 16
     until phase 37 was added, 8 until phase 39 was) with its
     area light replaced by a spot and a projector (an inline 64x64
     bitmap), a cylinder, a cone and a 12-triangle cube (the fused
     query), the ldsampler sampler, on the lane pool of 32,768 lanes
     (launches == queries); threefry's share (``ert::rng``) of a profiled
     spp4 render's busy device time; a 64x64 spp4 film through the kernel
     against the plain sweep (budget 2); value+grad at spp 2 (the walls'
     reflectance rows finite, not zero); sample_emitter_ray over 2^20
     lanes against the same call on the CPU (1e-6);
 32. the five samplers draw 2^20 lanes x 8 dimensions (next_1d,
     next_2d; spp 6, so the strata's divisions are not by powers of 2)
     bit-equal to the same calls on the CPU, ms a draw;
 33. slice 6a: bench.py's large3d (256x256, the 64^3 grid, 32,768 lanes,
     max_depth 12; spp 2, bench.py: 64) under its ablations:
     nee_transmittance "track", "quadrature" with 8 nodes, and
     ff_majorant "segment" with the residual walk; each render's time,
     launches (tile_sweep == queries, grid_gather == lookups), walk steps,
     lookup points and host syncs, its film within 3 standard errors of
     phase 10's residual film (the same estimand), and a 64x64 spp4 film
     through the kernels against the plain gather and the plain sweep
     (budget 2); the 64^3 density written to a .vol file
     (smoke_out/vol/) and read back nearest-filtered through
     use_grid_bbox (spp 2): grid_gather's gather entry launched once a
     lookup,
     the 64x64 films against the plain versions, and the gather entry on
     the render's table timed beside index_select; the flagship's
     atmosphere with an aerosol (a blendphase of Rayleigh and a 181-node
     tabphase of HG g = 0.7), an irregular ground reflectance and a
     5800 K blackbody sun (spp 2), its 64x64 film against the plain
     sweep; value+grad at 128x128 (256x256 until phase 37 was added) spp
     2, max_depth 6 (12 until phase 39 was), of the quadrature render and
     the nearest
     grid (d(mean)/d(grid, albedo); forward and backward launches, the
     film bit-equal to the primal's) and their 64x64 spp2 max_depth 3
     gradients (spp 4 until phase 37 was added, max_depth 6 until phase
     40 was, 4 until phase 41 was) through the kernels against the plain
     versions (rtol 1e-5, atol 1e-7);
 34. slice 7a: scenes from files, written under a temporary directory.
     (a) terrain(256) as a PLY, a seeded 1024x1024 f32 albedo map as a
     ZIP EXR feeding a diffuse bitmap (on the terrain, which has no uvs
     and reads the map's origin texel as in the reference, and on a
     ground rectangle around it), phase 30's 256x512 sky as an f16 PIZ
     EXR feeding an envmap, a directional sun, the bench camera at
     256x256, a box filter, path max_depth 6 and <default name="spp"
     value="16"/> used as $spp, written by scene/xml.py::write_file:
     load_file onto the card, every tensor bit-equal to load_dict's of
     the dict with the images inline; a pool of 2^18 lanes (tile_sweep
     launches == queries) whose film is within 2 pixels of the dict
     scene's; films.save to EXR, PFM and RGBE, the EXR and PFM read back
     bit-equal to the developed film. (b) bench.py's large3d written by
     write_file with its grid in a .vol file: its tensors bit-equal to
     load_dict's, rendered at spp 4 (seed 1) on 32,768 lanes, grid_gather
     launches == lookups, its film within 3 standard errors of phase 10's
     (same_estimand). (c) ``python -m eradiate_kernel_tpu_torch
     terrain.xml -o out.exr --regen -D spp=4`` as a subprocess: exit 0,
     its EXR within 2 pixels of the in-process film; runtime.render in
     passes of 65,536 samples with a checkpoint, stopped after the first
     pass and resumed: launches == queries, within 2 pixels of an
     uninterrupted render. The time of every write, read, load and render
     is printed;
 35. slice 6b: volpathmis and the AOV wrappers. (a) the flagship (spp 2,
     seed 1; bench.py: 64) under volpathmis and under volpath on the lane
     pool of 32,768 lanes: time, Msamples/s, iterations, host syncs, walk
     steps, peak memory, tile_sweep launches == queries (a sample and an
     iteration), the volpathmis film within 3 standard errors of phase
     9's volpath film (same_estimand); (b) large3d (spp 2, seed 1) the
     same, grid_gather launches == lookups > 0, its film against phase
     10's, and a 64x64 spp4 volpathmis film through the kernels against
     the plain gather and the plain sweep (budget 2); (c) aov (depth,
     position, both normals, uv, prim and shape index) over path on phase
     3's terrain(256) (spp 16) through the scan driver and a pool of 2^18
     lanes: the base films within 2 pixels of phase 3's and phase 17's,
     tile_sweep launches == the child's queries (phase 3's, phase 17's)
     + the AOV queries (one a scan pass, one a pool refill; the refill
     queries' device time from a profiled render), the two drivers' AOVs
     within 1e-5 and the prim index equal (but in 2 pixels) outside the
     pixels of the samples the
     scan driver splats into the next pixel (its float32 pixel + jitter
     rounds up; the pool writes a sample to its own pixel), and a 64x64
     spp4 max_depth 3 (6 until phase 40 was added) pool render through the
     kernel and the plain sweep with depth bit-equal and every AOV
     bit-equal where the prim index is; (d) duv_dx and duv_dy at 64x64
     spp4 through the scan driver's offset camera rays: finite, non-zero
     on every hit pixel; (e) moment over volpath on the flagship pool
     (spp 2, seed 1): its base film equal to (a)'s volpath film (the
     wrapper draws nothing), m2 >= mean^2 in every pixel; (f) films.save
     of (c)'s pool film with its AOVs to EXR, read back bit-equal under
     the reference's channel names;
 36. slice 6c-1: the spectral variant. (a) bench.py's spectral load
     (BENCH_SCENE=spectral: the flagship atmosphere under a 1x1 distant
     sensor, 262,144 samples, max_depth 12, residual NEE, seed 1, 32,768
     lanes) in spectral and in rgb: time, Msamples/s, iterations, host
     syncs, peak memory, tile_sweep launches == queries; the grey scene's
     Y the same in both within 3 standard errors (the per-sample variances
     from 8 batches of 16,384 samples each); spp 16,384 through the kernel
     against the plain sweep within 1e-5 relative; (b) bins over volpath
     (five bins over 360-830 nm) at spp 65,536: the base film bit-equal
     to volpath's alone, the bins' sum / 470 the base film's Y within 3
     standard errors; an nbins line (550 nm, tolerance 25) finite and > 0;
     (c) a flat 360-830 nm srf (the estimand of (a)) and a triangular
     640-690 nm srf at spp 65,536; (d) a chromatic 64^3 atmosphere
     (large3d at spp 2 in spectral, 4 until phase 39 was added, with a
     seeded 32^3 rgb albedo grid in
     [0.5, 0.95], packed at load as gridvolume_srgb): the rgb2spec fit's
     host seconds, fused-entry launches == trilinear lookups and
     gather-entry launches == srgb lookups (each volume_eval sweeps both
     grid kinds, as the reference's), 64x64 spp4 films through the
     kernels against the plain gather and the plain sweep (budget 2), and
     the gather entry on the packed 32-float rows beside index_select;
 37. slice 6c-2: the spectral variant's gradients, volpathmis, the AOV
     wrappers, the measured BSDF and emitter rays in spectral. (a)
     bench.py's spectral load (phase 36a's): value+grad of the image
     mean with respect to sigma_t on the lane pool (the path replay; its
     film bit-equal to the primal's) and on the scan driver (autograd
     through passes as wide as the pool: the einsum lookup's rows round
     differently at another batch width, which is recorded), the two
     gradients within tests/test_autodiff.py:348's rtol 5e-3, atol 1e-7;
     times, host syncs, peak memory, the ratio to the primal; (b) phase
     36d's chromatic 64^3 at 64x64 spp 2 max_depth 6 (12 until phase 39
     was added): value+grad of the 64^3 sigma_t
     and the 32^3 srgb albedo through the kernels against the plain
     gather and the plain sweep (rtol 1e-5, atol 1e-7), fused-entry
     launches == trilinear lookups, gather-entry launches == srgb
     lookups, grid_trilinear_bwd launches == the adjoint's trilinear
     lookups; (c) the same with sigma_t a gridvolume_spectral of 8 bands
     against the plain gather (grid_trilinear_bwd at C = 8; phase 13 times
     it); (d) moment over
     volpath on (a)'s load, its base film bit-equal to phase 36a's, and
     moment over volpathmis: volpathmis's Y within 3 standard errors of
     volpath's (the per-sample variances from m2.y; volpathmis at a
     quarter of the load since phase 39 was added); aov (depth, shading
     normal) over volpath on terrain(256) at 256x256 spp 4 on a pool of
     2^18 lanes (launches == queries, the refills' included; a depth
     where the alpha is); (e) phase 30's measured terrain in spectral at
     64x64 spp 4 max_depth 2 (3 until phase 40 was added; a 128x256 sky)
     through the kernel against
     the plain sweep (budget 2); sample_emitter_ray in spectral over 2^16
     lanes against the same call on the CPU (o, d within 1e-4,
     wavelengths 1e-5, weights 1e-4 relative);
 38. slice 6d: the double-precision variants (slice_6d_phases). (a) each
     kernel's float64 entry bit-equal to its float64 plain version on the
     float32 rows' loads (terrain(256) under 2^20 primary and incoherent
     rays, the rgb_double flagship's cube under 32,768 rays, the forest
     under 2^19 rays through both BVH kernels, the gather, trilinear and
     backward entries on a 64^3 table at C = 1, 3, 8; the backward within
     rtol 1e-12, atol 1e-15, and bit for bit on lanes whose corners no
     two lanes share), timed beside the
     float32 entry, the plain version and, for the gathers, index_select,
     grid_sample and grid_sample's backward in float64, the bound at the
     FP64 rate; (b) a unit sphere and the cube mesh hit from 1e5 away
     through the sweep and both BVH kernels: within 1e-6 in rgb_double,
     100x closer than rgb; (c) the flagship in rgb_double on the scan
     driver beside rgb (tile_sweep_f64 launches == queries, time, host
     syncs; the estimand within 3 standard errors with the ground lowered,
     the as-built z recorded); (d) large3d's 64x64 spp 2 value+grad in
     rgb_double through the kernels and the plain versions (launches ==
     lookups, the film the primal's bit for bit); (e) terrain(256) in
     rgb_double at 256x256 spp 2 max_depth 3 against the plain sweep
     (budget 2) and
     the forest through each BVH kernel's float64 entry; (f) bench.py's
     spectral load at max_depth 3 (6 until phase 42 was added) in
     spectral_double beside spectral
     (32,768 samples each, within 3 standard errors) and
     render(regen=True) raising in double;
     (g) phase 37e's emitter rays in spectral and spectral_double against
     the CPU, each kind's worst direction lane recorded;
 39. the polarized variant (slice 6e, Variant("rgb", polarized=True)):
     (a) bench.py's polarized load (64x64 spp 16, stokes(volpath)
     max_depth 8, residual NEE) on its lane pool of 4,096 lanes and on
     32,768 (fused tile_sweep launches == queries, S3 exactly 0, linear
     polarization made, each pixel's Y and S1..S3 within 3 standard errors
     of the scan driver's same samples); (b) an isotropic phase: the
     Mueller volpath's S0 against volpath's sample for sample, S1..S3 0;
     (c) the 64^3 grid under stokes(volpath) at 64x64 spp 2 (grid_gather
     launches == fused lookups); (d) terrain(256) with a pplastic ground
     under stokes(path) at 256x256 spp 2 max_depth 3 (the plain sweep's
     film: phase 40b); (e) Malus's law, crossed polarizers and a half-wave
     plate on the optical bench (no kernel);
 40. slices 6e-2 and 7b (slice_7b_phases): (a) value+grad of the 64^3
     atmosphere under stokes(volpath) (64x64 spp 2, grid and albedo) on
     the scan driver through the kernels and the plain gather
     (grid_gather and grid_trilinear_bwd launches == lookups); (b) the
     pplastic terrain(256) under stokes(path) (32x32 spp 2 max_depth 2,
     the rgb spectra) through the sorted sweep and the plain sweep
     (launches == queries); (c) the native tile and BVH builders (built
     with g++ in phase 1) bit-equal to their numpy versions on
     terrain(256) and the forest, with both host times, and the renders
     over native-built accelerators bit-equal to numpy-built ones'
     (tile_sweep, tile_bvh, tile_bvh8); (d) registered HG, diffuse,
     point-emitter and path clones against their built-ins (the HG clone
     in the 64^3 atmosphere on the lane pool); (e) the chi2 harness for
     hg, rayleigh, tabphase, rpv, pplastic and the HG clone; (f) the
     z-test harness on the flagship atmosphere at 32x32, and its
     detection of a changed albedo; (g) DWAA and DWAB through the OpenEXR
     bridge (or "exr_bridge: absent" and the refusal);
 41. slice 7c, parallel/ over torch.distributed (slice_7c_phases): (a)
     an NCCL group of one process a card (on one card the script itself,
     rank 0 of a world of 1, on a free TCP port), each rank's mesh two
     shards on its card: render_sharded(regen=True, regen_lanes=32768) of
     phase 10's large3d bit-equal to phase 10's film, tile_sweep and
     grid_gather launches == queries and lookups over the shards, the
     film's all_reduce timed; (b) two child processes sharing the card
     (gloo, backend="gloo": NCCL refuses two ranks on one GPU), one shard
     each: the same render split between them, both films bit-equal to
     phase 10's; sharded_film's value+grad of the 64^3 grid and the albedo
     at 64x64 spp 2 max_depth 6 (the scan driver) on each rank within rtol
     1e-5, atol 1e-7 of the script's one-shard value+grad,
     grid_trilinear_bwd launches == lookups, and one Adam step;
 42. slice 7d, the reference's remaining helpers and the BSDFs' transport
     mode (slice_7d_phases; no new kernel): (a) every warp slice 7d added and
     its pdf on 2^20 seeded lanes, the card against the CPU within 8
     float32 ulps of an O(1) value (a direction's x and y near the pole
     scaled by |cos| / sin); (b) solve_quadratic and legendre_p on 2^20
     lanes; (c) both transport modes of the six mode-dependent BSDFs on
     65,536 seeded interactions (sample, eval_pdf, the Mueller entry)
     within tests/test_torch_measured.py's budget, IMPORTANCE moving the
     card's rows where it moves the CPU's; (d) volume_eval_gradient at
     65,536 points of the 64^3 atmosphere through grid_gather against the
     plain gather, bit for bit;
 12. (last) print the kernels line (every kernel and entry, the backward
     and the float64 entries included, with their launches on phases
     21-41), the value+grad, measurement, materials, slice 5c-2, slice 6a,
     slice 7a, slice 6b, slice 6c-1, slice 6c-2, slice 6d, slice 6e,
     slice 7b, slice 7c and slice 7d records,
     the card's name and power limit, and the final ``{"ok": true, ...}``
     line.

``python3 chip_smoke.py --profile`` adds, before the report, a breakdown of
the full-width terrain, forest, flagship atmosphere and 64^3 atmosphere
renders and of the Cornell box, terrain, forest, materials Cornell box
and materials terrain renders on the lane pool: one torch.profiler pass
each, whose device time goes to the port's spans (``ert::query`` split by
its kernels, ``ert::volume_eval``, ``ert::rng``, ...; perfbench/spans.py)
and whose kernel tables go to smoke_out/profile_<scene>.txt.
"""

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from perfbench import devtrace, spans

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# each kernel's device functions (profiler rows are matched by these names)
KERNEL_FUNCS = {"tile_sweep": ("tile_sweep_kernel", "tile_sweep_small_kernel"),
                "tile_bvh": ("tile_bvh_kernel",),
                "tile_bvh8": ("tile_bvh8_kernel",),
                "grid_gather": ("grid_gather_kernel", "grid_trilinear_kernel",
                                "grid_trilinear_bwd_kernel")}
# SASS opcode families counted per kernel function: the reciprocal and
# the calls of its slow path, 32- and 128-bit shared loads, async copies,
# barriers, global reductions (Hopper's REDG: atomics whose result is
# unused), FP32 and FP64 arithmetic (an opcode counts under a family it
# equals or extends with a "." suffix; LDS only as itself)
SASS_OPS = ("MUFU.RCP", "CALL", "LDS", "LDS.128", "LDG.E.128", "LDGSTS",
            "BAR.SYNC", "BAR.RED", "WARPSYNC", "REDG", "FFMA", "FMUL",
            "FADD", "DFMA", "DMUL", "DADD")


def terrain(n=256, seed=0):
    """Heightfield mesh over [-1,1]^2 with fractal bumps: 2*(n-1)^2 tris
    (the repository's bench_mesh.py terrain)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1, 1, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    Z = np.zeros_like(X)
    for octave in range(1, 6):
        f = 2.0 ** octave
        ph = rng.uniform(0, 2 * np.pi, 4)
        Z += (np.sin(f * np.pi * X + ph[0]) * np.sin(f * np.pi * Y + ph[1])
              + np.cos(f * np.pi * (X + Y) + ph[2])) * (0.25 / f)
    V = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:]
    F = np.concatenate([
        np.stack([a, b, c], -1).reshape(-1, 3),
        np.stack([b, d, c], -1).reshape(-1, 3)]).astype(np.int32)
    return V, F


def make_rays(n_rays, kind, seed=1):
    """bench_mesh.py's ray loads: 'primary' (pinhole camera above the
    terrain looking down) or incoherent (random origins and directions)."""
    rng = np.random.default_rng(seed)
    if kind == "primary":
        o = np.array([0.0, -1.5, 1.2], np.float32)
        s = int(np.sqrt(n_rays))
        u = (np.arange(s) + 0.5) / s - 0.5
        U, Vv = np.meshgrid(u, u, indexing="ij")
        d = np.stack([U, 0.9 + 0.0 * U, -0.55 + 0.6 * Vv], axis=-1)
        d = d.reshape(-1, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.broadcast_to(o, d.shape)
        return o.astype(np.float32)[:n_rays], d.astype(np.float32)[:n_rays]
    o = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0.3, 1.0, n_rays)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def terrain_scene(V, F, width, height, spp, max_depth):
    """RPV terrain under a directional sun, seen by a perspective camera at
    the bench pose (o = (0, -1.5, 1.2), central direction (0, 0.9, -0.55);
    58 deg horizontal field of view spans the primary load's fan)."""
    return {
        "type": "scene",
        "terrain": {"type": "mesh", "vertices": V, "faces": F,
                    "bsdf": {"type": "rpv", "rho_0": 0.2, "g": -0.1,
                             "k": 0.7}},
        "sun": {"type": "directional", "direction": [0.3, 0.0, -0.94],
                "irradiance": 1.0},
        "camera": {
            "type": "perspective", "fov": 58.0,
            "to_world": {"type": "look_at", "origin": [0.0, -1.5, 1.2],
                         "target": [0.0, -0.6, 0.65], "up": [0, 0, 1]},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": max_depth},
    }


def forest_scene(width, height, spp, max_depth, n_inst=256):
    """bench_mesh.py's bench_forest: a terrain(33) crown scaled by 0.5
    (2,048 triangles in 16 tiles) in one shapegroup, instanced n_inst
    times, each a translate then a rotate about z placed from
    default_rng(4) as there; plus an RPV ground rectangle scaled by 9, the
    directional sun and a perspective camera from (0, -14, 7)."""
    rng = np.random.default_rng(4)
    V, F = terrain(33)
    d = {
        "type": "scene",
        "grp": {"type": "shapegroup",
                "crown": {"type": "mesh", "vertices": V * 0.5, "faces": F,
                          "bsdf": {"type": "diffuse"}}},
        "ground": {"type": "rectangle",
                   "to_world": {"type": "scale", "value": [9.0, 9.0, 1.0]},
                   "bsdf": {"type": "rpv", "rho_0": 0.2, "g": -0.1,
                            "k": 0.7}},
        "sun": {"type": "directional", "direction": [0.3, 0.0, -0.94],
                "irradiance": 1.0},
        "camera": {
            "type": "perspective", "fov": 60.0,
            "to_world": {"type": "look_at", "origin": [0.0, -14.0, 7.0],
                         "target": [0.0, 0.0, 0.0], "up": [0, 0, 1]},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": max_depth},
    }
    for i in range(n_inst):
        x, y = rng.uniform(-8, 8, 2)
        d[f"i{i}"] = {"type": "instance",
                      "shapegroup": {"type": "ref", "id": "grp"},
                      "to_world": [
                          {"type": "translate",
                           "value": [float(x), float(y),
                                     float(rng.uniform(0, 0.3))]},
                          {"type": "rotate", "axis": [0, 0, 1],
                           "angle": float(rng.uniform(0, 360))}]}
    return d


def write_obj(path, V, F):
    """A Wavefront OBJ of vertices V and triangles F (positions only; the
    shortest decimals that round-trip float32)."""
    with open(path, "w") as fh:
        fh.writelines(f"v {x!r} {y!r} {z!r}\n"
                      for x, y, z in V.astype(np.float32).tolist())
        fh.writelines(f"f {a} {b} {c}\n" for a, b, c in (F + 1).tolist())


def write_serialized(path, V, F, name="mesh"):
    """A one-mesh Mitsuba ``serialized`` file (version 4, float32, no
    normals or uvs): magic 0x041C, version, a zlib stream of flags, name,
    counts, positions and faces, then the footer of offsets and count."""
    import struct
    import zlib

    body = (struct.pack("<I", 0x1000) + name.encode() + b"\0"
            + struct.pack("<QQ", len(V), len(F))
            + np.ascontiguousarray(V, "<f4").tobytes()
            + np.ascontiguousarray(F, "<u4").tobytes())
    with open(path, "wb") as fh:
        fh.write(struct.pack("<HH", 0x041C, 4) + zlib.compress(body)
                 + struct.pack("<QI", 0, 1))


def sass_counts(name):
    """{kernel function: {opcode: count}} of kernel ``name``'s SASS, for the
    functions of KERNEL_FUNCS (their float64 instantiations as "<function>
    f64", an instantiation's integer template arguments as " <4>") and
    the opcodes of SASS_OPS, with every reduction and atomic opcode in
    full under "reductions" (its width, e.g. F32x4, is in the name); None
    where the toolkit has no cuobjdump."""
    from eradiate_kernel_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    sass = subprocess.run([cuobjdump, "-sass", _build._so_path(name)],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    op_re = re.compile(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Za-z0-9_.]*)")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            cur = next((k for k in KERNEL_FUNCS[name] if k in fn), None)
            if cur is not None:
                # a template's instantiation ("<name>I<type><literals>E",
                # mangled): float64 as "<name> f64", the literals listed
                rest = fn[fn.index(cur) + len(cur):]
                lits = re.match(r"I[a-z]*((?:L[a-z]\d+E)*)", rest)
                if rest.startswith("Id"):
                    cur += " f64"
                if lits and lits.group(1):
                    cur += " <" + ",".join(
                        re.findall(r"L[a-z](\d+)E", lits.group(1))) + ">"
                counts.setdefault(cur, collections.Counter())
            continue
        m = op_re.search(line)
        if cur is not None and m:
            counts[cur][m.group(1)] += 1
    fam = lambda op, key: op == key or (key != "LDS"
                                         and op.startswith(key + "."))
    out = {}
    for fn, c in counts.items():
        out[fn] = {key: sum(n for op, n in c.items() if fam(op, key))
                   for key in SASS_OPS}
        red = {op: n for op, n in c.items() if op.startswith(("RED", "ATOM"))}
        if red:
            out[fn]["reductions"] = red
    return out


_T0 = time.perf_counter()

# films and counts of earlier phases that phase 35 holds its renders to
REF_FILMS = {}

# the adjoint's own backward lanes (load B of the backward entry), captured
# in phases 14 and 37c by capture_bwd, held and timed in phase 13b
BWD_LOADS = {}


# the seconds since the script started at which each phase began
PHASE_STARTS = {}


def phase_clock(phase):
    """Print the seconds since the script started as phase ``phase``
    begins (where the run's time goes); the report prints them all."""
    PHASE_STARTS[phase] = round(time.perf_counter() - _T0, 1)
    print(f"# phase {phase} starts at {PHASE_STARTS[phase]} s", flush=True)


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps runs, by CUDA events, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_once(fn):
    """(fn(), its ms by CUDA events) for one run without a warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes, ops):
    """(least ms, what bounds it): bytes over the HBM rate against FP32
    operations over the FP32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def tile_bytes(n_tiles):
    from eradiate_kernel_tpu_torch.ops import intersect

    return n_tiles * intersect.TILE_K * (9 * 4 + 2 * 4)


def sweep_bound(args, visited):
    """Least time (ms) the card could take for one sweep: the larger of
    bytes moved / HBM rate and FP32 operations / FP32 peak. Bytes: rays in,
    each visit's (id, tnear) pair, counts, the tile arrays once, outputs.
    Operations: tiles visited x 256 x 128 tests x FLOPS_PER_TEST."""
    from eradiate_kernel_tpu_torch.ops import intersect

    rays, count = args[0], args[2]
    n_pad, nb = rays.shape[0], count.shape[0]
    visits = int(visited.sum())
    nbytes = (n_pad * 32 + visits * 8 + nb * 4 + tile_bytes(args[4].shape[0])
              + n_pad * (4 + 8 + 4 + 4) + nb * 4)
    ops = visits * intersect.RAY_BLOCK * intersect.TILE_K \
        * intersect.FLOPS_PER_TEST
    return bound(nbytes, ops) + (visits,)


def bvh_bound(args, stats, wide):
    """Least time (ms) the card could take for one BVH traversal. Bytes:
    rays in, the tree, instance rows and packed tile rows once, outputs and
    stats. Operations: leaves visited x BVH_GROUP x 128 tests x
    FLOPS_PER_TEST, plus inner nodes visited x BVH_GROUP rays x (2 or 8)
    children x FLOPS_PER_SLAB, from the per-group stats. (The TPU's 256-ray
    walk tests more: 1.3-3.6x on these loads, PERF.md.)"""
    from eradiate_kernel_tpu_torch.ops import intersect

    rays, g = args[0], intersect.BVH_GROUP
    tree = sum(a.numel() * 4 for a in args[1:5])
    inner, leaves = (int(x) for x in stats[:, :2].sum(0))
    nbytes = (rays.shape[0] * (32 + 20) + stats.numel() * 4 + tree
              + args[5].numel() * 4)
    ops = (leaves * g * intersect.TILE_K * intersect.FLOPS_PER_TEST
           + inner * g * (8 if wide else 2) * intersect.FLOPS_PER_SLAB)
    return bound(nbytes, ops) + (inner, leaves)


def films_equivalent(a, b, max_flips, tol=1e-4):
    """tests/conftest.py::assert_driver_equivalent: per-pixel agreement to
    tol x max(|a|, 1) except at most max_flips pixels, which must stay
    finite and bounded. Returns the number of differing pixels."""
    diff = np.abs(a - b).max(axis=-1)
    scale = np.abs(a).max(axis=-1) + 1e-6
    bad = diff > tol * np.maximum(scale, 1.0)
    assert bad.sum() <= max_flips, \
        f"{bad.sum()} pixels diverged (budget {max_flips}); max {diff.max()}"
    if bad.any():
        assert np.isfinite(b).all()
        assert diff[bad].max() < 10 * (np.abs(a).mean() + 1.0)
    return int(bad.sum())


def span_profile(fn):
    """``fn()`` under torch.profiler (CPU and CUDA) inside the benchmark's
    window span -> (seconds, the profiler, the trace's events, the window's
    devtrace and spans reductions merged). Nothing is synchronised inside
    ``fn``: each figure is device time put down to the port's spans
    (perfbench/spans.py)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    os.makedirs("smoke_out", exist_ok=True)
    path = os.path.join("smoke_out", f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    summary = {**devtrace.reduce_events(events), **spans.reduce_events(events)}
    return secs, prof, events, summary


def span_ms(summary, name):
    return summary["span_device_s"].get(name, 0.0) * 1e3


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the duration."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the render stages the port's spans mark (perfbench/spans.py), and the
# query's finer stages by the kernels launched inside ert::query (the
# other kernels there are the pre-passes: Morton keys, sort, masks)
STAGE_SPANS = ("ert::query", "ert::volume_eval", "ert::free_flight",
               "ert::rng", "ert::bsdf", "ert::phase", "ert::nee",
               "ert::film", "ert::pool.refill", "ert::pool.harvest")
QUERY_KERNELS = {"sweep kernel": ("tile_sweep_kernel",),
                 "fused sweep query": ("tile_sweep_small_kernel",),
                 "tile_bvh/tile_bvh8 kernel": ("tile_bvh_kernel",
                                               "tile_bvh8_kernel")}


def profile_render(render, render_s, label, window=None):
    """Where a full-width render's time goes (``render()`` runs it); prints
    '#' lines and writes the profiler's kernel table to
    smoke_out/profile_<label>.txt. The profiler traces ``window()`` (a
    shorter steady run of the same loop) when given, else the render; a
    window is also timed without the profiler for its busy share. The
    stages are the port's spans: device time launched inside each (nested
    spans count in each), the query's split by its kernels."""
    from torch.autograd import DeviceType

    from eradiate_kernel_tpu_torch.integrators import common

    if window is not None:
        render = window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    common.counters.update(host_syncs=0, pool_syncs=0)
    prof_s, prof, events, summary = span_profile(render)
    query = spans.kernels_inside(events, "ert::query")
    split = {k: sum(v for n, v in query.items() if any(f in n for f in fs))
             for k, fs in QUERY_KERNELS.items()}
    split["pre-passes"] = sum(query.values()) - sum(split.values())
    parts = ", ".join(f"{k} {span_ms(summary, k):.1f}" for k in STAGE_SPANS
                      if k in summary["span_count"])
    inside = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in split.items() if v)
    idle = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in sorted(
        summary["span_idle_s"].items(), key=lambda kv: -kv[1])[:6])
    print(f"# {label} render spans (device ms of the profiled run, busy "
          f"{summary['busy_s'] * 1e3:.1f} of {summary['window_s'] * 1e3:.1f}"
          f"): {parts}" + (f"; inside ert::query: {inside}" if inside
                           else "") + f"; idle by innermost span: {idle}",
          flush=True)
    counted_syncs = dict(common.counters)
    avgs = prof.key_averages()
    # device-side rows only: an aten op's row repeats its kernels' time
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    # busy: the union of the trace's device intervals (the rows' sum
    # counts some kernels more than once)
    busy_us = summary["busy_s"] * 1e6
    ours = {name: sum(e.self_device_time_total for e in kernels
                      if any(f in e.key for f in funcs))
            for name, funcs in KERNEL_FUNCS.items()}
    launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    syncs = sum(e.count for e in avgs if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", f"profile_{label}.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=50))
    if busy_us == 0:
        print(f"# {label} render profile: the profiler saw no device time "
              "(busy share not measured)", flush=True)
        return
    ours_txt = ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in ours.items())
    what = "window" if window else "render"
    print(f"# {label} render profile: device busy "
          f"{busy_us / 1e3:.1f} ms ({ours_txt}), busy share "
          f"{busy_us / 1e6 / render_s:.3f} of the unprofiled {what} "
          f"({render_s * 1e3:.1f} ms), {busy_us / 1e6 / prof_s:.3f} of "
          f"the profiled one ({prof_s * 1e3:.1f} ms); kernel launches "
          f"{launches}, host syncs {syncs} (any_lane sites "
          f"{counted_syncs['host_syncs']}, the lane pool's own "
          f"{counted_syncs['pool_syncs']})", flush=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:8]
    print(f"# {label} render profile, aten ops by device time (ms, calls): "
          + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} "
                      f"({e.count})" for e in ops), flush=True)


# each closest-hit query calls one of these once, whatever the accel
PREPARES = ("prepare_sweep", "prepare_small", "prepare_bvh")


@contextlib.contextmanager
def counting():
    """Inside the block, count the closest-hit queries (calls of the
    intersect functions in PREPARES), the gridvolume lookups (calls of
    volumes._trilinear_gather), the nearest-filter lookups (calls of
    volumes._nearest_gather), the points both looked up, and the srgb-packed
    lookups of the spectral variant (calls of volumes._srgb_corners, one
    gather-entry launch each). Every kernel's
    launch count, the host-sync
    counts and the replay's iteration counts are set to 0 on entry.
    Yields ``read()``: launches (kernel -> count), queries, lookups,
    host_syncs (the integrators' any_lane gates), pool_syncs (the lane
    pool's own), forward_iterations and adjoint_iterations."""
    from eradiate_kernel_tpu_torch.integrators import common, replay
    from eradiate_kernel_tpu_torch.ops import gather, intersect
    from eradiate_kernel_tpu_torch.textures import volumes

    counts = {"queries": 0, "lookups": 0, "nearest_lookups": 0,
              "srgb_lookups": 0, "lookup_points": 0}
    sites = [(intersect, name, "queries") for name in PREPARES] + [
        (volumes, "_trilinear_gather", "lookups"),
        (volumes, "_nearest_gather", "nearest_lookups"),
        (volumes, "_srgb_corners", "srgb_lookups")]
    originals = [getattr(mod, name) for mod, name, _ in sites]

    def counted(fn, what):
        def wrapper(*a, **kw):
            counts[what] += 1
            if what in ("lookups", "nearest_lookups"):
                # the lookup's points: pl is (..., 3), the last argument
                counts["lookup_points"] += a[-1].numel() // 3
            return fn(*a, **kw)
        return wrapper

    def read():
        return dict(launches={**intersect.launches, **gather.launches},
                    **counts, **common.counters, **replay.counters)

    for (mod, name, what), fn in zip(sites, originals):
        setattr(mod, name, counted(fn, what))
    try:
        torch.cuda.synchronize()
        for launches in (intersect.launches, gather.launches):
            launches.update(dict.fromkeys(launches, 0))
        common.counters.update(host_syncs=0, pool_syncs=0)
        replay.counters.update(forward_iterations=0, adjoint_iterations=0)
        yield read
    finally:
        for (mod, name, _), fn in zip(sites, originals):
            setattr(mod, name, fn)


def counted_render(scene, **render_kw):
    """Render ``scene`` through the scan driver under counting(), also
    counting the path tracer's bounces. Returns (image, seconds, launches,
    bounces, queries, rays traced)."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.integrators import path

    bounces = {"n": 0, "traced": 0.0}
    bounce = path._bounce

    def counted_bounce(*a, **kw):
        state = bounce(*a, **kw)
        bounces["n"] += 1
        bounces["traced"] = float(state.n_rays)
        return state

    path._bounce = counted_bounce
    try:
        with counting() as read:
            t0 = time.perf_counter()
            img = integrators.render(scene, seed=0, **render_kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read()
    finally:
        path._bounce = bounce
    return (img, seconds, counts["launches"], bounces["n"], counts["queries"],
            bounces["traced"])


def check_render(label, scene, img, seconds, launches, bounces, queries,
                 traced, kernel, mean_range):
    """Print a full-width render's line and hold its launches to its
    closest-hit queries."""
    cfg = scene.config
    assert img.shape == (cfg.film_height, cfg.film_width, 3)
    n_samples = cfg.film_height * cfg.film_width * cfg.spp
    mean = float(img.mean())
    print(f"# {label}: {seconds * 1e3:.1f} ms, "
          f"{n_samples / seconds / 1e6:.3f} Msamples/s, rays traced "
          f"{traced:.0f}, bounces {bounces}, closest-hit queries {queries}, "
          f"launches {launches}, image mean {mean:.5f}", flush=True)
    assert bool(torch.isfinite(img).all()), f"{label}: non-finite pixels"
    assert mean_range[0] < mean < mean_range[1], \
        f"{label}: image mean {mean} out of {mean_range}"
    # every mesh query of the render went through the kernel: one camera or
    # bounce query per bounce, and one shadow query per bounce but the last
    # (a path at max_depth ends before next-event estimation)
    assert launches[kernel] == queries, \
        f"{label}: {launches[kernel]} {kernel} launches, {queries} queries"
    assert sum(launches.values()) == launches[kernel], \
        f"{label}: other kernels launched: {launches}"
    assert bounces >= 1 and queries >= 2 * bounces - 1, \
        f"{label}: {queries} queries for {bounces} bounces"
    return mean


def check_atmosphere(label, scene, film, seconds, launches, counts):
    """Print an atmosphere render's line and hold its launches to its
    queries and lookups. Returns the render's record."""
    from eradiate_kernel_tpu_torch.films import develop

    cfg = scene.config
    img = develop(film)
    assert img.shape == (cfg.film_height, cfg.film_width, 3)
    assert bool(torch.isfinite(img).all()), f"{label}: non-finite pixels"
    n_samples = cfg.film_height * cfg.film_width * cfg.spp
    assert float(film[..., 4].sum()) == n_samples, f"{label}: samples lost"
    mean = float(img.mean())
    rec = dict(render_ms=seconds * 1e3,
               msamples_per_s=n_samples / seconds / 1e6,
               mrays_per_s=counts["rays"] / seconds / 1e6,
               rays=counts["rays"], iterations=counts["iterations"],
               host_syncs=counts["gate_syncs"],
               pool_syncs=counts["pool_syncs"], image_mean=mean,
               queries=counts["queries"], lookups=counts["lookups"],
               nearest_lookups=counts["nearest_lookups"],
               srgb_lookups=counts["srgb_lookups"],
               lookup_points=counts["lookup_points"], launches=launches)
    print(f"# {label}: {rec['render_ms']:.1f} ms, "
          f"{rec['msamples_per_s']:.3f} Msamples/s, "
          f"{rec['mrays_per_s']:.2f} Mrays/s ({counts['rays']:.0f} rays), "
          f"loop iterations {counts['iterations']}, host syncs (any_lane) "
          f"{counts['gate_syncs']} (+ the pool's {counts['pool_syncs']}), "
          f"closest-hit queries {counts['queries']}, gridvolume gathers "
          f"{counts['lookups']} (nearest {counts['nearest_lookups']}, srgb "
          f"{counts['srgb_lookups']}; {counts['lookup_points']} points), "
          f"launches {launches}, "
          f"image mean {mean:.5f}", flush=True)
    assert 0.01 < mean < 2.0, f"{label}: image mean {mean}"
    # the atmosphere cube is one 12-triangle tile: every mesh query of the
    # render was one launch of the fused sweep, every large-grid lookup one
    # launch of the fused trilinear lookup, every nearest-filter and
    # srgb-packed lookup one launch of the gather entry, and nothing else
    # was launched
    assert launches["tile_sweep"] == counts["queries"] > 0, \
        f"{label}: {launches['tile_sweep']} sweeps, {counts['queries']} queries"
    lookups = (counts["lookups"] + counts["nearest_lookups"]
               + counts["srgb_lookups"])
    assert launches["grid_gather"] == lookups, \
        f"{label}: {launches['grid_gather']} gathers, {lookups} lookups"
    assert launches["tile_bvh"] == launches["tile_bvh8"] == 0, launches
    return rec


def gather_load(table, idx):
    """The row-gather kernel against its plain version on one load, bit
    for bit; times of the kernel, the plain version and index_select; the
    bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import gather

    out = gather._gather_cuda(table, idx)
    ref = gather.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), "grid_gather differs from the plain gather"
    L, R = out.shape
    # bytes: each index read once, each gathered row read and written once
    nbytes = L * (idx.element_size() + 2 * R * 4)
    bound_ms, bound_by = bound(nbytes, 0)
    return dict(
        ms=cuda_ms(lambda: gather._gather_cuda(table, idx), reps=50),
        plain_ms=cuda_ms(lambda: gather.gather_rows_plain(table, idx),
                         reps=50),
        library_ms=cuda_ms(lambda: torch.index_select(table, 0, idx),
                           reps=50),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
        rows=table.shape[0], row_floats=R, lanes=L,
        device_us={"kernel": device_us(
            lambda: gather._gather_cuda(table, idx), ("grid_gather",)),
            "index_select": device_us(
                lambda: torch.index_select(table, 0, idx))})


def device_us(fn, names=None, reps=200):
    """Mean device time (us) a call of fn() of the kernels whose names
    contain one of ``names`` (every kernel when None), by torch.profiler
    over reps back-to-back calls; None if the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (names is None or any(n in e.key for n in names)))
    return total / reps if total else None


def gather_host_us(table, idx, n=2000, rounds=5):
    """Host time (us a call, time.perf_counter over n back-to-back calls,
    the median of ``rounds`` rounds that take the pieces in turn) of each
    piece of a gather launch: the generic dict-loop check (_build.check)
    and the lean direct one, the output allocation both ways, the stream
    lookup both ways, the ctypes call alone, the whole wrapper, and
    index_select."""
    from eradiate_kernel_tpu_torch.ops import _build, gather

    dev = table.device
    V, R = table.shape
    L = idx.shape[0]
    fn = gather._fn("grid_gather_launch")
    out = gather._gather_cuda(table, idx)
    raw = _build.stream(dev.index)
    assert raw == torch.cuda.current_stream(dev).cuda_stream
    launch = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), V, R, L,
              idx.dtype == torch.int64, R % 4 == 0, raw)
    pieces = {
        "generic check": lambda: _build.check(
            "grid_gather", {"table": (table, torch.float32, (V, R)),
                            "idx": (idx, idx.dtype, (L,))}, dev),
        "direct check": lambda: gather._check_rows(table, idx),
        "torch.empty": lambda: torch.empty(L, R, dtype=torch.float32,
                                           device=dev),
        "new_empty": lambda: table.new_empty((L, R)),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream": lambda: _build.stream(dev.index),
        "ctypes launch": lambda: fn(*launch),
        "wrapper": lambda: gather._gather_cuda(table, idx),
        "index_select": lambda: torch.index_select(table, 0, idx),
    }
    return host_us(pieces, n, rounds)


def host_us(pieces, n, rounds):
    """{name: host us a call of pieces[name]()}: time.perf_counter over n
    back-to-back calls, the median of ``rounds`` rounds that take the
    pieces in turn, each round's calls synchronised before and after."""
    times = {name: [] for name in pieces}
    for _ in range(rounds):
        for name, f in pieces.items():
            f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                f()
            times[name].append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def trilinear_load(grid, packed, slot, pl):
    """The fused trilinear lookup against the plain chain on one load, bit
    for bit; times of both and of grid_sample, the one PyTorch call that
    computes the same lookup (on the unpacked grid of one slot); the
    bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import gather
    from eradiate_kernel_tpu_torch.textures import volumes

    grid_shape = grid.shape
    out = gather.grid_trilinear(packed, grid_shape, slot, pl)
    ref = volumes.trilinear_gather_plain(packed, grid_shape, slot, pl)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), "grid_trilinear differs from the plain chain"
    L, C = out.shape
    # grid_sample with align_corners=True maps g in [-1, 1] to g' = (g + 1)
    # / 2 * (n - 1) and clamps it to [0, n - 1] under 'border': the lookup's
    # clamp(p, 0, 1) * (n - 1), up to the rounding of p * 2 - 1
    assert grid_shape[0] == 1 and not bool(slot.any())
    vol = grid.permute(0, 4, 1, 2, 3).contiguous()
    g = (pl * 2 - 1).view(1, 1, 1, L, 3)

    def library():
        return torch.nn.functional.grid_sample(
            vol, g, mode="bilinear", padding_mode="border",
            align_corners=True)

    lib_err = float((library().reshape(C, L).T - out).abs().max())
    assert lib_err < 1e-5, f"grid_sample differs from the lookup by {lib_err}"
    # bytes: the point, the slot, the 8C-float row, the result; operations:
    # the corner setup (4 an axis) and 7 lerps of 3 a channel
    bound_ms, bound_by = bound(L * (12 + 4 + 8 * C * 4 + C * 4),
                               L * (12 + 21 * C))
    return dict(
        ms=cuda_ms(lambda: gather.grid_trilinear(packed, grid_shape, slot,
                                                 pl), reps=50),
        plain_ms=cuda_ms(lambda: volumes.trilinear_gather_plain(
            packed, grid_shape, slot, pl), reps=50),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
        library_ms=cuda_ms(library, reps=50), library_max_abs_err=lib_err,
        rows=packed.shape[0], channels=C, lanes=L,
        device_us={"kernel": device_us(lambda: gather.grid_trilinear(
            packed, grid_shape, slot, pl), ("grid_trilinear",)),
            "plain chain": device_us(lambda: volumes.trilinear_gather_plain(
                packed, grid_shape, slot, pl)),
            "grid_sample": device_us(library)})


def trilinear_bwd_bytes(shape, slot, pl, size):
    """Bytes the lookup's backward must move on one load: the points, the
    slots and the cotangent read once (``size`` bytes a value), and a
    voxel's C values written once for each distinct voxel that the lanes'
    8 edge-clamped corners touch (the caller zeroes the rest of d_grid)."""
    from eradiate_kernel_tpu_torch.textures import volumes

    S, D, H, W, C = shape
    L = slot.numel()
    r = volumes._corner0((S, D, H, W), slot, pl)[0].reshape(-1).clamp(
        0, S * D * H * W - 1).long()
    x, y, z = r % W, r // W % H, r // (W * H) % D
    base = r - (z * H + y) * W - x
    corners = torch.stack([
        base + ((z + dz).clamp(max=D - 1) * H + (y + dy).clamp(max=H - 1))
        * W + (x + dx).clamp(max=W - 1)
        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])
    return L * (3 * size + 4 + C * size) + (
        torch.unique(corners).numel() * C * size)


def trilinear_bwd_load(grid, slot, pl, ct):
    """The lookup's backward kernel against its plain version on one load:
    rtol 1e-5 and atol 1e-7 on d_grid, since the atomics add in an order
    that changes from run to run; times of both and of the one PyTorch call
    that computes the same gradient, torch.autograd.grad of grid_sample
    with respect to the unpacked grid (its backward alone: the forward is
    kept with retain_graph); the bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import gather
    from eradiate_kernel_tpu_torch.textures import volumes

    shape = tuple(grid.shape)
    out = gather.grid_trilinear_bwd(ct, shape, slot, pl)
    ref = volumes.trilinear_backward_plain(ct, shape, slot, pl)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)
    err = float((out - ref).abs().max())
    L, C = ct.shape
    assert shape[0] == 1 and not bool(slot.any())
    vol = grid.permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
    with torch.enable_grad():
        sampled = torch.nn.functional.grid_sample(
            vol, (pl * 2 - 1).view(1, 1, 1, L, 3), mode="bilinear",
            padding_mode="border", align_corners=True)
    ct_lib = ct.T.reshape(1, C, 1, 1, L).contiguous()

    def library():
        return torch.autograd.grad(sampled, vol, ct_lib, retain_graph=True)[0]

    # grid_sample's fractions differ from the lookup's by the rounding of
    # p * 2 - 1 (trilinear_load), so its gradient differs by as much
    lib_err = float((library().permute(0, 2, 3, 4, 1) - out).abs().max())
    assert lib_err < 1e-4, f"grid_sample's gradient differs by {lib_err}"
    # operations: the corner setup (12) and 14 a channel
    bound_ms, bound_by = bound(trilinear_bwd_bytes(shape, slot, pl, 4),
                               L * (12 + 14 * C))
    return dict(
        ms=cuda_ms(lambda: gather.grid_trilinear_bwd(ct, shape, slot, pl),
                   reps=50),
        plain_ms=cuda_ms(lambda: volumes.trilinear_backward_plain(
            ct, shape, slot, pl), reps=50),
        library_ms=cuda_ms(library, reps=50), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
        channels=C, lanes=L,
        device_us={"kernel": device_us(lambda: gather.grid_trilinear_bwd(
            ct, shape, slot, pl), ("grid_trilinear_bwd",)),
            "plain": device_us(lambda: volumes.trilinear_backward_plain(
                ct, shape, slot, pl)),
            "grid_sample backward": device_us(library)})


def bwd_host_us(ct, shape, slot, pl, n=2000, rounds=5):
    """Host time (us a call, host_us) of each piece of a backward launch:
    the reshapes, the argument check, the zeroed d_grid (new_zeros and
    torch.zeros), the stream lookup, the ctypes call alone and the whole
    wrapper."""
    from eradiate_kernel_tpu_torch.ops import _build, gather

    S, D, H, W, C = shape
    dev = ct.device
    L = slot.shape[0]
    fn = gather._fn("grid_trilinear_bwd_launch", ct.dtype)
    d_grid = gather.grid_trilinear_bwd(ct, shape, slot, pl)
    launch = (ct.data_ptr(), pl.data_ptr(), slot.data_ptr(),
              d_grid.data_ptr(), S * D * H * W, D, H, W, C, L,
              _build.stream(dev.index))
    pieces = {
        "reshapes": lambda: (ct.reshape(-1, C).contiguous(),
                             slot.reshape(-1).contiguous(),
                             pl.reshape(-1, 3).contiguous()),
        "check": lambda: gather._check_bwd(ct, pl, slot),
        "new_zeros": lambda: ct.new_zeros(shape),
        "torch.zeros": lambda: torch.zeros(shape, dtype=ct.dtype,
                                           device=dev),
        "raw stream": lambda: _build.stream(dev.index),
        "ctypes launch": lambda: fn(*launch),
        "wrapper": lambda: gather.grid_trilinear_bwd(ct, shape, slot, pl),
    }
    return host_us(pieces, n, rounds)


@contextlib.contextmanager
def capture_bwd(into):
    """Record the (ct, grid shape, slot, pl) of the grid_trilinear_bwd
    call with the most lanes made while the context is open (the
    adjoint's own lanes; ties: the first) into dict ``into``, by wrapping
    gather.grid_trilinear_bwd for the duration (the wrapped call runs and
    counts as before)."""
    from eradiate_kernel_tpu_torch.ops import gather

    orig = gather.grid_trilinear_bwd

    def wrapped(ct, grid_shape, slot, pl):
        L = slot.numel()
        if L > into.get("lanes", 0):
            into.update(lanes=L, shape=tuple(grid_shape),
                        ct=ct.detach().reshape(L, -1).clone(),
                        slot=slot.reshape(L).clone(),
                        pl=pl.detach().reshape(L, 3).clone())
        return orig(ct, grid_shape, slot, pl)

    gather.grid_trilinear_bwd = wrapped
    try:
        yield into
    finally:
        gather.grid_trilinear_bwd = orig


def bwd_warp_lanes(C, dtype=torch.float32):
    """Lanes a warp of the backward kernel holds at C channels: a thread
    takes a chunk of 4, 2 or 1 floats (1 double), the chunk fastest (at C
    = 3, 10 or 11 lanes; 10 here)."""
    vec = (1 if dtype == torch.float64 else
           4 if C % 4 == 0 else 2 if C % 2 == 0 else 1)
    return max(1, 32 // min(C // vec, 8))


def shared_row_share(shape, slot, pl, warp_lanes):
    """The share of lanes whose corner c000 row another lane of the same
    warp (consecutive groups of ``warp_lanes`` lanes) shares: the lanes
    the backward's warp aggregation can merge."""
    from eradiate_kernel_tpu_torch.textures import volumes

    S, D, H, W = shape[:4]
    r = volumes._corner0((S, D, H, W), slot, pl)[0].reshape(-1).clamp(
        0, S * D * H * W - 1).long()
    n = r.numel() // warp_lanes * warp_lanes
    if n == 0:
        return 0.0
    g = r[:n].reshape(-1, warp_lanes)
    same = (g[:, :, None] == g[:, None, :]).sum(-1) > 1
    return float(same.float().mean())


def adjoint_bwd_loads():
    """Phase 13b: the backward entry on the adjoint's own lanes (load B):
    the calls phases 14 (large3d, C = 1) and 37c (the 8-band chromatic
    64^3, C = S37_BANDS) captured, in float32 as captured and in float64
    (the same lanes widened) against the plain version (rtol 1e-5, atol
    1e-7; float64 1e-12, 1e-15), with the share of lanes whose corner row
    another lane of their warp shares, the kernel's device time a call and
    the bound. Returns the loads' records."""
    from eradiate_kernel_tpu_torch.ops import gather
    from eradiate_kernel_tpu_torch.textures import volumes

    phase_clock("13b")
    out = {}
    for name, cap in BWD_LOADS.items():
        if not cap:
            continue
        shape = cap["shape"]
        L, C = cap["ct"].shape
        for dtype, tol in ((torch.float32, (1e-5, 1e-7)),
                           (torch.float64, (1e-12, 1e-15))):
            ct, pl, slot = cap["ct"].to(dtype), cap["pl"].to(dtype), cap[
                "slot"]
            got = gather.grid_trilinear_bwd(ct, shape, slot, pl)
            ref = volumes.trilinear_backward_plain(ct, shape, slot, pl)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=tol[0], atol=tol[1])
            bound_ms, bound_by = bound(trilinear_bwd_bytes(
                shape, slot, pl, ct.element_size()), 0)
            rec = out[f"{name} C={C} {str(dtype)[6:]}"] = dict(
                lanes=L, channels=C, grid=list(shape),
                max_abs_err=float((got - ref).abs().max()),
                shared_row_share=shared_row_share(
                    shape, slot, pl, bwd_warp_lanes(C, dtype)),
                bound_ms=bound_ms, bound_by=bound_by,
                device_us=device_us(lambda: gather.grid_trilinear_bwd(
                    ct, shape, slot, pl), ("grid_trilinear_bwd",)))
            print(f"# 13b grid_trilinear_bwd on {name}'s adjoint lanes "
                  f"({L} lanes, C={C}, {str(dtype)[6:]}): within "
                  f"{rec['max_abs_err']:.2e} of the plain version; "
                  f"{rec['shared_row_share']:.3f} of lanes share their "
                  f"corner row with another lane of their warp; kernel "
                  f"{rec['device_us']} us device a call, bound "
                  f"{bound_ms * 1e3:.3f} us ({bound_by})", flush=True)
    assert len(out) == 4, sorted(out)
    return out


def distinct_corner_lanes(n, dev, gen):
    """Lanes at every other voxel of an n^3 grid along each axis plus a
    fraction in [0.1, 0.9]: no two lanes share a corner."""
    ar = torch.arange(0, n - 1, 2, device=dev)
    z, y, x = torch.meshgrid(ar, ar, ar, indexing="ij")
    idx = torch.stack([x.flatten(), y.flatten(), z.flatten()], -1)
    frac = 0.1 + 0.8 * torch.rand(idx.shape, generator=gen).to(dev)
    return (idx + frac) / (n - 1)


def value_grad(scene, n_lanes, keys, threefry=False, with_primal=True):
    """The lane pool's value+grad of the developed image's mean with
    respect to the ParameterMap keys ``keys``, through the user's entry
    points (autodiff.traverse, integrators.render(regen=True),
    loss.backward()), after a primal render of the same scene and seed.
    The counts of counting() are read after the value+grad's forward and
    after its backward. With ``threefry``, one more value+grad, profiled:
    threefry's device time (``ert::rng``) and its share of the run's busy
    device time. Without ``with_primal`` no primal render (and no film
    check): the value+grad
    alone. Returns (record, the parameters with their .grad)."""
    from eradiate_kernel_tpu_torch import films, integrators
    from eradiate_kernel_tpu_torch.films import develop
    from eradiate_kernel_tpu_torch.utils import autodiff

    pm = autodiff.traverse(scene).keep(keys)
    render = lambda sc: integrators.render(
        sc, seed=0, samples_per_pass=n_lanes, regen=True, develop_film=False)
    if with_primal:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        primal_film = render(scene)
        torch.cuda.synchronize()
        primal_s = time.perf_counter() - t0

    params = pm.trainable()
    with counting() as read:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        film = render(pm.with_trainable(params))
        loss = develop(film).mean()
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        fwd = read()
        loss.backward()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        end = read()
        peak = torch.cuda.max_memory_allocated()
    bwd = {k: ({kk: vv - fwd[k][kk] for kk, vv in v.items()}
               if isinstance(v, dict) else v - fwd[k])
           for k, v in end.items()}
    rec = dict(value_grad_ms=total_s * 1e3, forward_ms=forward_s * 1e3,
               backward_ms=(total_s - forward_s) * 1e3,
               forward=fwd, backward=bwd, peak_bytes=peak,
               loss=float(loss.detach()),
               film_sums=film.detach().sum((0, 1)).tolist())
    if with_primal:
        if films._single_pixel(scene.config.rfilter,
                               dict(scene.config.rfilter_params)):
            assert torch.equal(film.detach(), primal_film), \
                "the value+grad film differs from the primal render's"
        else:  # a wide splat adds with atomics, in no fixed order
            torch.testing.assert_close(film.detach(), primal_film,
                                       rtol=1e-5, atol=1e-5)
        rec.update(primal_ms=primal_s * 1e3,
                   value_grad_over_primal=total_s / primal_s)
    if threefry:
        p2 = pm.trainable()
        prof_s, _prof, _events, summary = span_profile(
            lambda: develop(render(pm.with_trainable(p2))).mean().backward())
        rec.update(threefry_ms=span_ms(summary, "ert::rng"),
                   profiled_ms=prof_s * 1e3,
                   busy_ms=summary["busy_s"] * 1e3,
                   threefry_share=span_ms(summary, "ert::rng")
                   / (summary["busy_s"] * 1e3))
    return rec, params


def check_value_grad(label, scene, rec, params):
    """Print a value+grad's line and hold it to its counts: one sweep
    launch a closest-hit query and one lookup launch a gridvolume lookup,
    forward and adjoint, one backward launch a lookup of the adjoint, and
    finite gradients that are not all zero (the spectra on the sun's row:
    the RPV rows' gradient is NaN in the reference too, ROADMAP Queue
    3)."""
    a = {k: v.detach().cpu().numpy() for k, v in scene.tensors().items()}
    sun = int(a["spec_slot"][a["emitters.directional.irradiance"][0]])
    grads = {}
    for k, p in params.items():
        g = p.grad[sun] if k == "spectra.baked.value" else p.grad
        assert g is not None and bool(torch.isfinite(g).all()), \
            f"{label}: {k} gradient not finite"
        assert bool(g.abs().sum() > 0), f"{label}: {k} gradient all zero"
        grads[k] = float(g.abs().sum())
    rec["grad_abs_sums"] = grads
    fwd, bwd = rec["forward"], rec["backward"]
    for part in (fwd, bwd):
        la = part["launches"]
        assert la["tile_sweep"] == part["queries"] > 0, (label, part)
        assert la["grid_gather"] == part["lookups"] + part[
            "nearest_lookups"], (label, part)
        assert la["tile_bvh"] == la["tile_bvh8"] == 0, (label, part)
    assert fwd["launches"]["grid_trilinear_bwd"] == 0, (label, fwd)
    assert bwd["launches"]["grid_trilinear_bwd"] == bwd["lookups"], \
        (label, bwd)
    print(f"# {label} value+grad: primal {rec['primal_ms']:.1f} ms, "
          f"value+grad {rec['value_grad_ms']:.1f} ms (forward "
          f"{rec['forward_ms']:.1f}, backward {rec['backward_ms']:.1f}; "
          f"{rec['value_grad_over_primal']:.2f}x the primal), loop "
          f"iterations forward {fwd['forward_iterations']} adjoint "
          f"{bwd['adjoint_iterations']}, host syncs (any_lane) forward "
          f"{fwd['host_syncs']} backward {bwd['host_syncs']} (+ the pool's "
          f"{fwd['pool_syncs']} + {bwd['pool_syncs']}), launches "
          f"forward {fwd['launches']} backward {bwd['launches']}, "
          f"closest-hit queries {fwd['queries']} + {bwd['queries']}, "
          f"gridvolume lookups {fwd['lookups']} + {bwd['lookups']} "
          f"(nearest {fwd['nearest_lookups']} + {bwd['nearest_lookups']}), "
          f"peak "
          f"memory {rec['peak_bytes'] / 2**20:.1f} MiB, loss "
          f"{rec['loss']:.6f}, |grad| sums {grads}"
          + (f", threefry {rec['threefry_ms']:.1f} device ms of a profiled "
             f"run's {rec['busy_ms']:.1f} busy ({rec['profiled_ms']:.1f} "
             f"ms; share {rec['threefry_share']:.3f})" if "threefry_ms" in rec
             else ""), flush=True)
    return rec


def small_query_load(tiles, ray):
    """One closest-hit query of a small tile set through intersect_tiles:
    one counted launch of the fused query, bit-equal to its plain version
    (visits included); the eager sorted pipeline's sweep bit-equal to its
    plain version and its t equal to the fused query's; times of the fused
    query, its plain version, the eager pipeline and the eager pipeline's
    kernel alone; the bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import intersect

    n = ray.o.shape[0]
    args = intersect.prepare_small(tiles, ray)
    before = intersect.launches["tile_sweep"]
    out = intersect.intersect_tiles(tiles, ray, return_visited=True)
    torch.cuda.synchronize()
    assert intersect.launches["tile_sweep"] == before + 1, \
        "the fused query is not one tile_sweep launch"
    ref = intersect._sweep_small_plain(*args)
    for what, a, b in zip(("t", "uv", "prim", "shape", "visits"), out, ref):
        assert torch.equal(a, b), f"fused sweep: {what} differs"
    eager_args, _unsort, _n = intersect.prepare_sweep(tiles, ray)
    e_out = intersect.sweep(*eager_args)
    e_ref = intersect._sweep_plain(*eager_args)
    for what, a, b in zip(("t", "uv", "prim", "shape", "visits"), e_out,
                          e_ref):
        assert torch.equal(a, b), f"sorted sweep: {what} differs"
    e_full = intersect.intersect_tiles_sorted(tiles, ray)
    assert torch.equal(e_full[0], out[0]), "fused and sorted t differ"
    T = tiles["lo"].shape[0]
    nb = out[4].shape[0]
    visits, eager_visits = int(out[4].sum()), int(e_out[4].sum())
    # bytes: the ray fields, the root and tile boxes and the tiles once, the
    # outputs; operations: tiles visited x 256 x 128 tests, counting the
    # visits the query needs: the fewer of the two orders' (the unsorted
    # blocks' extra visits are the fused query's own cost)
    nbytes = n * 32 + 24 + T * 24 + tile_bytes(T) + n * 20 + nb * 4
    ops = (min(visits, eager_visits) * intersect.RAY_BLOCK * intersect.TILE_K
           * intersect.FLOPS_PER_TEST)
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(
        ms=cuda_ms(lambda: intersect.intersect_tiles(tiles, ray), reps=50),
        plain_ms=cuda_ms(lambda: intersect._sweep_small_plain(*args),
                         reps=5),
        eager_pipeline_ms=cuda_ms(
            lambda: intersect.intersect_tiles_sorted(tiles, ray), reps=20),
        eager_kernel_ms=cuda_ms(lambda: intersect.sweep(*eager_args),
                                reps=50),
        bound_ms=bound_ms, bound_by=bound_by, visits=visits,
        eager_visits=eager_visits, fused_extra_visits=visits - eager_visits,
        tiles=T, rays=n,
        device_us={"kernel": device_us(
            lambda: intersect.intersect_tiles(tiles, ray),
            ("tile_sweep_small",), reps=50),
            "eager pipeline": device_us(
                lambda: intersect.intersect_tiles_sorted(tiles, ray),
                reps=20)},
        hit_frac=float(torch.isfinite(out[0]).float().mean()),
        max_abs_err=0.0)


def crossover_load(tiles, ray):
    """The fused query (unsorted, one launch) against the sorted pipeline
    on a tile set that either can serve, whatever SWEEP_FUSED_MAX_TILES
    routes: the same t; the time and the tile visits of each. Returns the
    load's record."""
    from eradiate_kernel_tpu_torch.ops import intersect

    def fused():
        return intersect.sweep_small(*intersect.prepare_small(tiles, ray))

    def srt():
        return intersect.intersect_tiles_sorted(tiles, ray,
                                                return_visited=True)

    f_out, s_out = fused(), srt()
    assert torch.equal(f_out[0], s_out[0]), "fused and sorted t differ"
    rec = dict(tiles=tiles["lo"].shape[0], rays=ray.o.shape[0],
               fused_ms=cuda_ms(fused, reps=10),
               sorted_ms=cuda_ms(srt, reps=10),
               fused_visits=int(f_out[4].sum()),
               sorted_visits=int(s_out[4].sum()))
    rec["fused_over_sorted"] = rec["fused_ms"] / rec["sorted_ms"]
    return rec


def check_bvh_load(name, tiles, ray, n_rays):
    """One BVH kernel against its plain version on one ray load: hits and
    stats bit for bit; times of the kernel, the plain version and the full
    query; the bound. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import intersect

    wide = name == "tile_bvh8"
    args, _unsort, _n = intersect.prepare_bvh(tiles, ray, wide=wide)
    out = intersect._traverse_cuda(name, *args)
    ref, plain_ms = cuda_once(lambda: intersect._PLAIN_WALKS[name](*args))
    hit = torch.isfinite(out[0]) & torch.isfinite(ref[0])
    max_err = (float((out[0][hit] - ref[0][hit]).abs().max())
               if hit.any() else 0.0)
    for what, a, b in zip(("t", "uv", "prim", "shape", "stats"), out, ref):
        assert torch.equal(a, b), f"{name}: {what} differs from the plain"
    deepest = int(out[4][:, 2].max())
    assert deepest <= intersect.STACK_SIZE, f"{name}: stack overflow"
    ms = cuda_ms(lambda: intersect._traverse_cuda(name, *args), reps=10)
    full_ms = cuda_ms(lambda: intersect.intersect_bvh(tiles, ray, wide=wide),
                      reps=5)
    bound_ms, bound_by, inner, leaves = bvh_bound(args, out[4], wide)
    hit = torch.isfinite(out[0][:n_rays])
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err,
                bound_ms=bound_ms, bound_by=bound_by, inner_visits=inner,
                leaf_visits=leaves, deepest_stack=deepest,
                hit_frac=float(hit.float().mean()),
                intersect_ms=full_ms, mrays_per_s=n_rays / full_ms / 1e3)


def render_kernel_stage(scene, name):
    """Render ``scene`` once with every BVH traversal synchronised before
    and after and its host time summed (the kernel stage), and the bound
    summed over the launches from each launch's visits. Returns the
    stage's record."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.ops import intersect

    wide = name == "tile_bvh8"
    traverse = intersect.traverse
    rec = dict(stage_ms=0.0, launches=0, bound_ms=0.0, inner_visits=0,
               leaf_visits=0, bound_by=collections.Counter())

    def timed(nm, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = traverse(nm, *args)
        torch.cuda.synchronize()
        rec["stage_ms"] += (time.perf_counter() - t0) * 1e3
        rec["launches"] += 1
        b_ms, b_by, inner, leaves = bvh_bound(args, out[4], wide)
        rec["bound_ms"] += b_ms
        rec["bound_by"][b_by] += 1
        rec["inner_visits"] += inner
        rec["leaf_visits"] += leaves
        return out

    saved = dict(intersect.launches)
    intersect.traverse = timed
    try:
        integrators.render(scene, seed=0)
    finally:
        intersect.traverse = traverse
        intersect.launches.update(saved)
    rec["ms_per_launch"] = rec["stage_ms"] / rec["launches"]
    rec["bound_ms_per_launch"] = rec["bound_ms"] / rec["launches"]
    rec["bound_by"] = rec["bound_by"].most_common(1)[0][0]
    return rec


def counted_pool(scene, n_lanes, seed=0, spp=None):
    """render(scene, regen=True) (the lane pool; samples_per_pass lanes)
    under counting(), with the pool's loop iterations, dropped samples and
    rays traced read from integrators._run_pool. Host syncs: ``gate_syncs``
    are the any_lane gates of the integrator's bounce, ``pool_syncs`` the
    pool's own (its dead-lane count every iteration, and nonzero on those
    that refill). Returns (film, seconds, launches, counts)."""
    from eradiate_kernel_tpu_torch import integrators

    run_pool = integrators._run_pool
    pool = {}

    def counted_run_pool(*a, stats=None, **kw):
        stats = {} if stats is None else stats
        pool["rays"] = float(run_pool(*a, stats=stats, **kw))
        pool.update(stats)
        return torch.tensor(pool["rays"])

    integrators._run_pool = counted_run_pool
    try:
        with counting() as read:
            t0 = time.perf_counter()
            film = integrators.render(scene, seed=seed, spp=spp, regen=True,
                                      samples_per_pass=n_lanes,
                                      develop_film=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = read()
    finally:
        integrators._run_pool = run_pool
    counts = dict(queries=got["queries"], lookups=got["lookups"],
                  nearest_lookups=got["nearest_lookups"],
                  srgb_lookups=got["srgb_lookups"],
                  lookup_points=got["lookup_points"], **pool,
                  gate_syncs=got["host_syncs"], pool_syncs=got["pool_syncs"])
    counts["host_syncs"] = counts["gate_syncs"] + counts["pool_syncs"]
    counts["gate_sync_share"] = counts["gate_syncs"] / counts["host_syncs"]
    return film, seconds, got["launches"], counts


def check_pool(label, scene, film, seconds, launches, counts, kernel,
               mean_range):
    """Print a lane-pool render's line and hold its launches: one launch
    of ``kernel`` a closest-hit query and no other kernel launched (with
    ``kernel`` None, no kernel launched at all). Returns its record."""
    from eradiate_kernel_tpu_torch import films

    cfg = scene.config
    img = films.develop(film, cfg.variant.mode)
    n_samples = cfg.film_height * cfg.film_width * cfg.spp
    assert bool(torch.isfinite(img).all()), f"{label}: non-finite pixels"
    if films._single_pixel(cfg.rfilter, dict(cfg.rfilter_params)):
        # one pixel a sample, weight 1
        assert float(film[..., 4].sum()) == n_samples, \
            f"{label}: samples lost"
    assert counts["dropped"] == 0, f"{label}: {counts}"
    mean = float(img.mean())
    rec = dict(render_ms=seconds * 1e3,
               msamples_per_s=n_samples / seconds / 1e6,
               mrays_per_s=counts["rays"] / seconds / 1e6, image_mean=mean,
               launches=launches, **counts)
    print(f"# {label}: {rec['render_ms']:.1f} ms, "
          f"{rec['msamples_per_s']:.3f} Msamples/s, "
          f"{rec['mrays_per_s']:.2f} Mrays/s ({counts['rays']:.0f} rays), "
          f"loop iterations {counts['iterations']}, host syncs "
          f"{counts['host_syncs']} (pool {counts['pool_syncs']}, bounce "
          f"gates {counts['gate_syncs']}: share "
          f"{counts['gate_sync_share']:.3f}), closest-hit queries "
          f"{counts['queries']}, launches {launches}"
          + ("" if kernel else " (no kernel: analytic shapes only)")
          + f", image mean {mean:.5f}", flush=True)
    assert mean_range[0] < mean < mean_range[1], \
        f"{label}: image mean {mean} out of {mean_range}"
    if kernel is None:
        assert sum(launches.values()) == 0, (label, launches)
    else:
        assert launches[kernel] == counts["queries"] > 0, (label, launches,
                                                           counts)
        assert sum(launches.values()) == launches[kernel], (label, launches)
    return rec


def spec_row(scene, tex):
    """The spectra.baked.value row of constant texture index ``tex``."""
    spec = int(scene.textures["constant"]["spec"][scene.tex_slot[tex]])
    return int(scene.spec_slot[spec])


def surface_value_grad(label, scene, n_lanes, kernel, rows):
    """value_grad of a surface scene with respect to spectra.baked.value,
    held to its counts: one ``kernel`` launch a closest-hit query forward
    and in the adjoint, no other kernel; the gradient rows ``rows`` (name
    -> row) finite and not all zero. Prints its line; returns its
    record."""
    rec, params = value_grad(scene, n_lanes, ["spectra.baked.value"])
    g = params["spectra.baked.value"].grad
    rec["grad_rows"] = {}
    for name, row in rows.items():
        assert bool(torch.isfinite(g[row]).all()), f"{label}: {name} grad"
        assert bool(g[row].abs().sum() > 0), f"{label}: {name} grad zero"
        rec["grad_rows"][name] = g[row].tolist()
    fwd, bwd = rec["forward"], rec["backward"]
    for part in (fwd, bwd):
        la = part["launches"]
        assert la[kernel] == part["queries"] > 0, (label, part)
        assert sum(la.values()) == la[kernel], (label, part)
    print(f"# {label} value+grad: primal {rec['primal_ms']:.1f} ms, "
          f"value+grad {rec['value_grad_ms']:.1f} ms (forward "
          f"{rec['forward_ms']:.1f}, backward {rec['backward_ms']:.1f}; "
          f"{rec['value_grad_over_primal']:.2f}x the primal), loop "
          f"iterations forward {fwd['forward_iterations']} adjoint "
          f"{bwd['adjoint_iterations']}, host syncs forward: bounce gates "
          f"{fwd['host_syncs']}, pool {fwd['pool_syncs']}; backward: "
          f"bounce gates {bwd['host_syncs']}, pool {bwd['pool_syncs']}; "
          f"{kernel} "
          f"launches forward {fwd['launches'][kernel]} backward "
          f"{bwd['launches'][kernel]} (= closest-hit queries "
          f"{fwd['queries']} + {bwd['queries']}), peak memory "
          f"{rec['peak_bytes'] / 2**20:.1f} MiB, loss {rec['loss']:.6f}, "
          f"gradient rows {rec['grad_rows']}", flush=True)
    return rec


def surface_phases(scene, forest, V, F, render_s, forest_runs, lanes, atmo):
    """Phases 15-20 (slice 5a): the Cornell box, the analytic gates, the
    terrain and the forest on the lane pool and through the path replay,
    and the atmosphere under a constant sky. ``scene``, ``forest``,
    ``render_s`` and ``forest_runs`` are phases 3 and 6's terrain and
    forest and their scan renders; ``atmo`` receives the sky-lit
    atmosphere's record. Returns (pool records, gate values, value+grad
    records)."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import (atmosphere,
                                                         cornell_box, furnace)

    # ---- 15. the Cornell box at full width on the lane pool --------------------
    phase_clock("15")
    # cornell_box(256, 256, spp=32, max_depth=6): 2,097,152 samples (spp 64
    # until phase 37 was added: the time limit); six analytic rectangles:
    # no kernel runs
    cbox = load_dict(cornell_box(256, 256, 32, 6))
    integrators.render(cbox, seed=0, spp=1, regen=True,
                       samples_per_pass=lanes)  # warm-up
    film, secs_c, launches, counts = counted_pool(cbox, lanes)
    pools = {"cornell box": check_pool(
        "cornell box 256x256 spp32 max_depth 6 (lane pool)", cbox, film,
        secs_c, launches, counts, None, (0.05, 0.5))}
    small_cbox = load_dict(cornell_box(64, 64, 4, 6))
    scan = integrators.render(small_cbox, seed=3, develop_film=False)
    pool = integrators.render(small_cbox, seed=3, regen=True,
                              samples_per_pass=lanes, develop_film=False)
    flips = films_equivalent(scan.cpu().numpy(), pool.cpu().numpy(),
                             max_flips=2)
    print(f"# cornell box 64x64 spp4: lane pool vs scan driver films agree "
          f"({flips} pixels over tolerance, budget 2)", flush=True)

    # ---- 16. the analytic gates on the card ----------------------------------
    phase_clock("16")
    env_scene = load_dict({
        "type": "scene", "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 64, "height": 64,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "env": {"type": "constant", "radiance": 0.7}})
    gates = {}
    for regen in (False, True):
        img = integrators.render(env_scene, regen=regen,
                                 samples_per_pass=lanes)
        gates[f"env regen={regen}"] = float((img - 0.7).abs().max())
        assert gates[f"env regen={regen}"] <= 1e-3, gates
    img = integrators.render(load_dict(furnace(0.5, 1.0, 16, 16, 128, 16)),
                             seed=3, regen=True, samples_per_pass=lanes)
    centre = img[6:10, 6:10].mean(dim=(0, 1))
    gates["furnace centre"] = centre.tolist()
    assert bool(((centre - 0.5).abs() < 0.02).all()), gates
    medium_furnace = load_dict({
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 256,
                       "rr_depth": 1000},
        "sensor": {"type": "perspective", "fov": 30.0,
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent",
                               "sample_count": 128}},
        "bound": {"type": "sphere", "radius": 1.0,
                  "interior": {"type": "homogeneous", "sigma_t": 1.0,
                               "albedo": 1.0}},
        "env": {"type": "constant", "radiance": 1.0}})
    img = integrators.render(medium_furnace, seed=2, regen=True,
                             samples_per_pass=lanes)
    gates["volumetric furnace mean"] = float(img.mean())
    gates["volumetric furnace centre"] = float(img[4, 4].mean())
    assert abs(gates["volumetric furnace mean"] - 1.0) < 0.03, gates
    assert abs(gates["volumetric furnace centre"] - 1.0) < 0.12, gates
    print(f"# analytic gates: constant environment 0.7 -> max error "
          f"{gates['env regen=False']:.2e} (scan), "
          f"{gates['env regen=True']:.2e} (pool); furnace(0.5, 1.0) centre "
          f"{centre.tolist()} (0.5 within 0.02); volumetric furnace L "
          f"{gates['volumetric furnace mean']:.4f}, centre "
          f"{gates['volumetric furnace centre']:.4f} (1 within 0.03 and "
          f"0.12)", flush=True)

    # ---- 17-18. terrain(256) and the forest on the lane pool -----------------
    phase_clock("17-18")
    # 2^18 lanes: four fills of the 1,048,576 samples
    pool_lanes = 1 << 18
    integrators.render(scene, seed=0, spp=1, regen=True,
                       samples_per_pass=pool_lanes)  # warm-up
    film, secs_t, launches, counts = counted_pool(scene, pool_lanes)
    pools["terrain"] = check_pool(
        "terrain render 256x256 spp16 max_depth 6 (lane pool)", scene, film,
        secs_t, launches, counts, "tile_sweep", (0.005, 0.5))
    REF_FILMS.update({"terrain pool film": film,
                      "terrain pool queries": counts["queries"]})
    # the scan driver splats a sample at pixel + jitter in float32, which
    # rounds up into the next pixel when the jitter is within half an ulp
    # of 1; the pool writes it to its own pixel: 12 of the 1,048,576
    # samples move, so 24 pixels flip (the same 24 in every run;
    # scan_moved_pixels), and the budget is 64, not the 2 of the 64x64
    # films
    scan = integrators.render(scene, seed=0, develop_film=False)
    flips = films_equivalent(scan.cpu().numpy(), film.cpu().numpy(),
                             max_flips=64)
    pools["terrain"].update(scan_ms=render_s * 1e3, flips_vs_scan=flips)
    print(f"# terrain 256x256 spp16: lane pool vs scan driver films agree "
          f"({flips} pixels over tolerance, budget 64); scan render "
          f"{render_s * 1e3:.1f} ms", flush=True)
    for name, wide in (("tile_bvh", "0"), ("tile_bvh8", "1")):
        with env(ERT_BVH_WIDE=wide):
            integrators.render(forest, seed=0, spp=1, regen=True,
                               samples_per_pass=pool_lanes)  # warm-up
            film, secs_f, launches, counts = counted_pool(forest, pool_lanes)
        pools[f"forest {name}"] = check_pool(
            f"forest render 256x256 spp16 max_depth 6 ({name}, lane pool)",
            forest, film, secs_f, launches, counts, name, (0.005, 0.5))
        pools[f"forest {name}"]["scan_ms"] = forest_runs[name]["render_ms"]

    # ---- 19. value+grad through the path replay: forest and terrain(256) ------
    phase_clock("19")
    # spp 2 (the primal phases take 16; cut from 4 when phase 35 was
    # added): the time limit
    surface_vg = {}
    vg_scenes = {
        "terrain": (load_dict(terrain_scene(V, F, 256, 256, 2, 6)), "0",
                    "tile_sweep"),
        "forest": (load_dict(forest_scene(256, 256, 2, 6)), "0",
                   "tile_bvh")}
    for label, (sc, wide, kernel) in vg_scenes.items():
        rows = {"sun": spec_row(sc, int(
            sc.emitters["directional"]["irradiance"][0]))}
        if label == "forest":  # the crown's diffuse reflectance
            rows["crown"] = spec_row(sc, int(
                sc.bsdfs["diffuse"]["reflectance"][0]))
        with env(ERT_BVH_WIDE=wide):
            surface_vg[label] = surface_value_grad(
                f"{label} 256x256 spp2 max_depth 6", sc, pool_lanes, kernel,
                rows)
    # at 32x32 spp2 max_depth 2 (64x64 until phase 39 was added; spp 4 and
    # max_depth 3 until phase 37 was; the value+grads above take 6) the
    # gradients through each
    # kernel and through its plain version: the plain walks' time, one host
    # sync a walk step (the RPV rows are NaN in both: ROADMAP Queue 3). The
    # terrain is terrain(64) (63 tiles: still the sorted sweep) and the
    # forest has 64 instances (terrain(256) and 256 until phase 41 was
    # added): the plain sorted sweep's time grows with the tiles, the plain
    # walks' with the tree
    V64, F64 = terrain(64)
    for label, d_small, wide, kernel in (
            ("terrain(64)", terrain_scene(V64, F64, 32, 32, 2, 2), "0",
             "tile_sweep"),
            ("forest 64 instances", forest_scene(32, 32, 2, 2, n_inst=64),
             "0", "tile_bvh"),
            ("forest 64 instances", forest_scene(32, 32, 2, 2, n_inst=64),
             "1", "tile_bvh8")):
        sc = load_dict(d_small)
        grads_64 = {}
        t0 = time.perf_counter()
        for how, ctx in (("kernels", contextlib.nullcontext),
                         ("plain", intersect.use_plain)):
            with env(ERT_BVH_WIDE=wide), ctx():
                rec, params = value_grad(sc, lanes, ["spectra.baked.value"],
                                         with_primal=False)
            grads_64[how] = params["spectra.baked.value"].grad
            # the kernel leg launched its kernel once a query, forward and
            # in the adjoint; the plain leg launched nothing
            for part in (rec["forward"], rec["backward"]):
                want = part["queries"] if how == "kernels" else 0
                assert part["queries"] > 0, (label, kernel, how, part)
                assert part["launches"][kernel] == want, (label, how, part)
                assert sum(part["launches"].values()) == want, (how, part)
        g, ref = grads_64["kernels"], grads_64["plain"]
        ok = torch.isfinite(ref)
        assert torch.equal(ok, torch.isfinite(g)), label
        torch.testing.assert_close(g[ok], ref[ok], rtol=1e-5, atol=1e-7)
        print(f"# {label} 32x32 spp2 max_depth 2 value+grad: {kernel} vs "
              f"plain gradients agree (rtol 1e-5, atol 1e-7; max abs err "
              f"{float((g[ok] - ref[ok]).abs().max()):.2e}; both legs "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 20. the atmosphere under a constant sky: volpath's MIS walk ----------
    phase_clock("20")
    def sky_atmosphere(*args, **kw):
        d = atmosphere(*args, **kw)
        d["integrator"]["nee_transmittance"] = "residual"
        d["sky"] = {"type": "constant", "radiance": 0.1}
        return load_dict(d)

    # 128x128 (256x256 until phase 39 was added): the time limit
    sky = sky_atmosphere(128, 128, 4, 12, grid_res=64)
    assert sky.config.env_emitter >= 0
    film, secs_s, launches, counts = counted_pool(sky, lanes)
    atmo["sky"] = check_atmosphere(
        "sky-lit atmosphere 128x128 spp4 max_depth 12 grid 64", sky, film,
        secs_s, launches, counts)
    small_sky = sky_atmosphere(64, 64, 4, 12, grid_res=64)
    film_k, _ = integrators.render_wavefront_regen(small_sky, lanes, 3, 4)
    with intersect.use_plain():
        film_p, _ = integrators.render_wavefront_regen(small_sky, lanes, 3,
                                                       4)
    flips = films_equivalent(film_p.cpu().numpy(), film_k.cpu().numpy(),
                             max_flips=2)
    print(f"# sky-lit atmosphere 64x64 spp4: tile_sweep kernel vs plain "
          f"films agree ({flips} pixels over tolerance, budget 2)",
          flush=True)
    if "--profile" in sys.argv[1:]:
        # the profiler traces a 4-spp window of the same pool
        profile_render(
            lambda: integrators.render(cbox, seed=0, regen=True,
                                       samples_per_pass=lanes),
            secs_c, "cbox", window=lambda: integrators.render(
                cbox, seed=0, spp=4, regen=True, samples_per_pass=lanes))
        profile_render(
            lambda: integrators.render(scene, seed=0, regen=True,
                                       samples_per_pass=pool_lanes),
            secs_t, "terrain_pool")
        profile_render(
            lambda: integrators.render(forest, seed=0, regen=True,
                                       samples_per_pass=pool_lanes),
            pools["forest tile_bvh"]["render_ms"] / 1e3, "forest_pool")
    return pools, gates, surface_vg


# tests/test_single_scattering_oracle.py's slab, closed form and CASES (a
# copy: that module imports the JAX package)
SS_CASES = [
    # (profile kind, albedo, rho, phase, d_sun, d_view)
    ("exp", 0.9, 0.0, "rayleigh", (0.3, 0.0, -0.954), (0.0, 0.0, -1.0)),
    ("exp", 0.8, 0.3, "rayleigh", (0.35, 0.1, -0.93), (0.4, -0.2, -0.9)),
    ("exp", 0.9, 0.0, "isotropic", (0.0, 0.45, -0.89), (-0.3, 0.0, -0.95)),
    ("linear", 0.7, 0.15, "rayleigh", (0.2, -0.3, -0.93), (0.0, 0.0, -1.0)),
]


def ss_profile(kind, D=16):
    z = (np.arange(D) + 0.5) / D
    if kind == "exp":
        profile = np.exp(-z / 0.25)
        return profile * (0.5 / profile.mean())
    return 0.8 * (1.0 - z) + 0.1


def ss_slab_scene(profile, albedo, rho, phase, d_sun, d_view, spp):
    """The plane-parallel slab in z [0, 1] (the atmosphere's geometry) with
    its ground 0.01 below the medium, a Lambertian ground, the
    directional sun, a 1x1 distant sensor; volpath max_depth 2."""
    D = len(profile)
    sigma = np.broadcast_to(
        np.asarray(profile, np.float32)[:, None, None], (D, 4, 4)).copy()
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 2, "rr_depth": 100},
        "sensor": {
            "type": "distant", "direction": list(-np.asarray(d_view)),
            "target": [0.5, 0.5, 0.0],
            "film": {"width": 1, "height": 1, "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
        "surface": {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": 20.0},
                         {"type": "translate", "value": [0.5, 0.5, -0.01]}],
            "bsdf": {"type": "diffuse", "reflectance": float(rho)}},
        "atmo": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [20.0, 20.0, 0.5]},
                         {"type": "translate", "value": [0.5, 0.5, 0.5]}],
            "bsdf": {"type": "null"},
            "interior": {
                "type": "heterogeneous",
                "sigma_t": {"type": "gridvolume", "data": sigma,
                            "to_world": [{"type": "scale",
                                          "value": [40.0, 40.0, 1.0]},
                                         {"type": "translate",
                                          "value": [-19.5, -19.5, 0.0]}]},
                "albedo": float(albedo), "phase": {"type": phase}}},
        "sun": {"type": "directional", "direction": list(d_sun),
                "irradiance": 1.0},
    }


def ss_closed_form(profile, albedo, rho, phase, d_sun, d_view):
    """TOA radiance at one scattering order: sky plus ground (the
    reference test's formula; tau from node-centred interpolation)."""
    zs = np.linspace(0.0, 1.0, 8001)
    sig = np.interp(zs, np.linspace(0.0, 1.0, len(profile)), profile)
    tau = np.trapezoid(sig, zs)
    d_s = np.asarray(d_sun, np.float64) / np.linalg.norm(d_sun)
    w = -np.asarray(d_view, np.float64) / np.linalg.norm(d_view)
    mu0, mu = -d_s[2], w[2]
    cos_theta = float(np.dot(d_s, w))
    p = (3.0 / (16.0 * np.pi) * (1.0 + cos_theta ** 2) if phase == "rayleigh"
         else 1.0 / (4.0 * np.pi))
    m = 1.0 / mu + 1.0 / mu0
    return (albedo * p * mu0 / (mu + mu0) * (1.0 - np.exp(-tau * m))
            + mu0 * rho / np.pi * np.exp(-tau * m))


def splat_bound(n, H, W, n_taps, gather=False):
    """Least time (ms) of a wide splat (or its adjoint gather) of n samples
    into an H x W x 5 film: each input read once (positions, 5 values or
    the film), each output written once; operations: per sample the
    2 n_taps filter weights (~10 operations each: the exp counted as 4),
    n_taps^2 weight products and n_taps^2 x 5 multiply-adds."""
    nbytes = n * 8 + (H * W * 5 * 4 + n * 5 * 4) \
        + (n * 5 * 4 if gather else H * W * 5 * 4)
    ops = n * (2 * n_taps * 10 + n_taps * n_taps * (1 + 2 * 5))
    return bound(nbytes, ops)


def splat_index_put(image, pos, values, kind):
    """film_put's wide splat with index_put_(accumulate=True) in place of
    index_add_ (timed beside it: the former sorts its indices on the card,
    the latter adds with atomics)."""
    from eradiate_kernel_tpu_torch import films

    H, W, C = image.shape
    iy, ix, wy, wx = films._taps(image, pos, kind, None)
    flat = image.view(H * W, C)
    for r in range(iy.shape[1]):
        w = wy[:, r:r + 1] * wx
        flat.index_put_(((iy[:, r:r + 1] * W + ix).reshape(-1),),
                        (values[:, None, :] * w[..., None]).reshape(-1, C),
                        accumulate=True)
    return image


def measurement_phases(V, F, lanes, box_ms):
    """Phases 21-25 (slice 5b): Eradiate's measurement path. The 1D
    atmosphere under distant sensors (mono, mdistant, rgb), the
    single-scattering anchor, the sensors' analytic gates and a
    bilambertian furnace, the forest's BRF under a distant sensor with
    the BVH kernels on parallel rays, and the reference's default filter
    (gaussian) on terrain(256): scan, pool, value+grad and the splat, its
    times beside ``box_ms``, the box film's scan and pool render ms of
    phases 3 and 17. Returns the phases' records."""
    from eradiate_kernel_tpu_torch import films, integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    rec = {}
    dev = torch.device("cuda")

    # ---- 21. Eradiate's 1D atmosphere under distant sensors ------------------
    phase_clock("21")
    # a quarter of bench.py's distant load (262,144 samples a call, W*H*spp
    # // 16 at 256x256, spp 64, until phase 39 was added: the time limit)
    # on the flagship's atmosphere (grid 64, max_depth 12, residual NEE)
    n_distant = 1 << 16
    sun = np.asarray([0.3, 0.0, -0.94])

    def distant_atmosphere(variant, sensor=None):
        d = atmosphere(spp=n_distant, max_depth=12, grid_res=64,
                       sun_direction=tuple(sun), sensor="distant")
        d["integrator"]["nee_transmittance"] = "residual"
        if sensor is not None:
            d["sensor"] = sensor
        return load_dict(d, Variant(variant))

    # 128 view zeniths in [-75, 75] degrees in the sun's principal plane
    # (x-z); mdistant takes the ray direction, down towards the target
    zen = np.deg2rad(np.linspace(-75.0, 75.0, 128))
    pp_dirs = np.stack([-np.sin(zen), np.zeros_like(zen), -np.cos(zen)], -1)
    runs = {
        "mono distant 1x1": distant_atmosphere("mono"),
        "mono mdistant 128 principal plane": distant_atmosphere("mono", {
            "type": "mdistant", "directions": pp_dirs.tolist(),
            "target": [0.5, 0.5, 0.0],
            "sampler": {"type": "independent",
                        "sample_count": n_distant // 128}}),
        "rgb distant 1x1": distant_atmosphere("rgb"),
    }
    integrators.render(runs["mono distant 1x1"], seed=0, spp=1 << 12,
                       regen=True, samples_per_pass=lanes)  # warm-up
    rec["atmosphere"] = {}
    for label, sc in runs.items():
        cfg = sc.config
        assert cfg.film_width * cfg.film_height * cfg.spp == n_distant
        film, secs, launches, counts = counted_pool(sc, lanes)
        r = check_pool(f"atmosphere {label} spp {cfg.spp} max_depth 12 "
                       "grid 64", sc, film, secs, launches, counts,
                       "tile_sweep", (1e-4, 2.0))
        img = films.develop(film, cfg.variant.mode)
        r["radiance"] = img.reshape(-1).tolist()
        rec["atmosphere"][label] = r
    pp = np.asarray(rec["atmosphere"]["mono mdistant 128 principal plane"][
        "radiance"]).reshape(-1)
    assert pp.shape == (128,) and np.isfinite(pp).all() and (pp >= 0).all()
    assert pp.max() > 0
    print(f"# principal plane (mono, 128 view zeniths -75..75 deg): "
          f"radiance min {pp.min():.5f} max {pp.max():.5f} at view zenith "
          f"{np.rad2deg(zen[int(pp.argmax())]):.1f} deg", flush=True)

    # ---- 22. the single-scattering anchor ------------------------------------
    phase_clock("22")
    rec["single_scattering"] = {}
    for kind, albedo, rho, phase, d_sun, d_view in SS_CASES:
        profile = ss_profile(kind)
        expected = ss_closed_form(profile, albedo, rho, phase, d_sun, d_view)
        # 16,384 samples a seed (65,536 until phase 39 was added, 262,144
        # until phase 37 was: the time limit; the gate follows the
        # standard error)
        sc = load_dict(ss_slab_scene(profile, albedo, rho, phase, d_sun,
                                     d_view, 1 << 14))
        t0 = time.perf_counter()
        vals = np.asarray([float(integrators.render(
            sc, seed=100 + s, regen=True, samples_per_pass=lanes).mean())
            for s in range(4)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mean, stderr = vals.mean(), vals.std(ddof=1) / 2.0
        tol = 4.0 * stderr + 0.005 * expected
        label = f"{kind} {phase} albedo {albedo} rho {rho}"
        rec["single_scattering"][label] = dict(
            mean=mean, expected=expected, stderr=stderr, tol=tol,
            ms=secs * 1e3)
        print(f"# single scattering {label}: {mean:.6f} vs closed form "
              f"{expected:.6f} (stderr {stderr:.2e}, gate {tol:.2e}; 4 seeds "
              f"x 16,384 samples in {secs * 1e3:.0f} ms)", flush=True)
        assert abs(mean - expected) < tol, (label, mean, expected, tol)

    # ---- 23. the sensors' analytic gates and a bilambertian furnace ------------
    phase_clock("23")

    def env_render(sensor, radiance=0.7, extra=None, max_depth=4):
        d = {"type": "scene",
             "integrator": {"type": "path", "max_depth": max_depth},
             "sensor": {**sensor, "sampler": {"type": "independent",
                                              "sample_count": 4096}},
             "env": {"type": "constant", "radiance": radiance}}
        d.update(extra or {})
        return integrators.render(load_dict(d), seed=1, regen=True,
                                  samples_per_pass=lanes)

    box = {"type": "box"}
    f1 = {"width": 1, "height": 1, "rfilter": box}
    gates = {}
    for label, sensor, want in (
            ("distant single", {"type": "distant", "direction": [0, 0, 1],
                                "film": f1}, 0.7),
            ("distant plane", {"type": "distant", "target": [0, 0, 0],
                               "film": {"width": 8, "height": 1,
                                        "rfilter": box}}, 0.7),
            ("distant hemisphere", {"type": "distant", "target": [0, 0, 0],
                                    "film": {"width": 4, "height": 4,
                                             "rfilter": box}}, 0.7),
            ("mdistant", {"type": "mdistant", "directions": [
                [0, 0, -1], [0.6, 0, -0.8], [0, 0.6, -0.8]]}, 0.7),
            ("mradiancemeter", {"type": "mradiancemeter",
                                "origins": [[0, 0, 3], [5, 5, 3]],
                                "directions": [[0, 0, -1], [0, 0, 1]]}, 0.7),
            ("distant cross-section slanted",
             {"type": "distant", "direction": [0.6, 0.0, 0.8], "film": f1},
             0.7 / 0.8)):
        err = float((env_render(sensor) - want).abs().max())
        gates[label] = err
        assert err <= 1e-3, (label, err)
    flux = float(env_render({"type": "distantflux", "film": {
        "width": 4, "height": 4, "rfilter": box}}, 1.0)[..., 1].sum())
    gates["distantflux sum"] = flux
    assert abs(flux - np.pi) < 0.01 * np.pi, flux
    irr = float(env_render({"type": "irradiancemeter", "film": f1,
                            "shape": {"type": "ref", "id": "meter"}}, 1.0,
                           {"meter": {"type": "rectangle",
                                      "bsdf": {"type": "diffuse",
                                               "reflectance": 0.0}}})[0, 0, 1])
    gates["irradiancemeter"] = irr
    assert abs(irr - np.pi) < 0.02 * np.pi, irr
    # r + t = 1: every bounce carries weight 1 back to the sky
    leaf = env_render({"type": "distant", "direction": [0, 0, 1],
                       "target": [0, 0, 0], "film": f1}, 1.0,
                      {"plane": {"type": "rectangle",
                                 "to_world": {"type": "scale",
                                              "value": 100.0},
                                 "bsdf": {"type": "bilambertian",
                                          "reflectance": 0.6,
                                          "transmittance": 0.4}}},
                      max_depth=64)
    gates["bilambertian furnace"] = leaf.reshape(-1).tolist()
    assert bool(((leaf - 1.0).abs() < 0.01).all()), gates
    rec["gates"] = gates
    print(f"# sensor gates (constant environment, spp 4096, lane pool): "
          f"{json.dumps(gates)}", flush=True)

    # ---- 24. the forest's BRF under a distant sensor --------------------------
    phase_clock("24")
    pool_lanes = 1 << 18
    d = forest_scene(64, 64, 64, 6)
    d["camera"] = {"type": "distant", "target": [0.0, 0.0, 0.15],
                   "film": {"width": 64, "height": 64, "rfilter": box},
                   "sampler": {"type": "independent", "sample_count": 64}}
    brf = load_dict(d)
    assert dict(brf.config.sensor_static)["direction_mode"] == "hemisphere"
    rec["forest_brf"] = {}
    for name, wide in (("tile_bvh", "0"), ("tile_bvh8", "1")):
        with env(ERT_BVH_WIDE=wide):
            integrators.render(brf, seed=0, spp=1, regen=True,
                               samples_per_pass=pool_lanes)  # warm-up
            film, secs, launches, counts = counted_pool(brf, pool_lanes)
        rec["forest_brf"][name] = check_pool(
            f"forest BRF distant 64x64 hemisphere spp64 max_depth 6 ({name},"
            " lane pool)", brf, film, secs, launches, counts, name,
            (0.005, 1.0))
    # the first bounce of a single-direction distant sensor: 2^18 parallel
    # rays over the bounding sphere's cross-section
    d["camera"] = {"type": "distant", "direction": [0.0, 0.0, 1.0],
                   "film": f1, "sampler": {"type": "independent",
                                           "sample_count": 1 << 18}}
    nadir = load_dict(d)
    _smp, ray, _w, _pos = integrators._camera_lanes(
        nadir, 0, 1 << 18, torch.arange(1 << 18, device=dev))
    rec["forest_parallel"] = {}
    for name in ("tile_bvh", "tile_bvh8"):
        r = check_bvh_load(name, nadir.geo.tiles(), ray, 1 << 18)
        rec["forest_parallel"][name] = r
        print(f"# {name} forest 2^18 parallel nadir rays: kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.1f} ms (bit-equal), "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), inner nodes "
              f"{r['inner_visits']}, leaves {r['leaf_visits']}, hits "
              f"{r['hit_frac']:.3f}, intersect {r['intersect_ms']:.3f} ms "
              f"({r['mrays_per_s']:.1f} Mrays/s)", flush=True)

    # ---- 25. the reference's default filter on terrain(256) -------------------
    phase_clock("25")
    d = terrain_scene(V, F, 256, 256, 16, 6)
    del d["camera"]["film"]["rfilter"]  # gaussian, stddev 0.5, radius 2
    gauss = load_dict(d)
    assert gauss.config.rfilter == "gaussian"
    integrators.render(gauss, seed=0, spp=1)  # warm-up
    img, scan_s, launches, bounces, queries, traced = counted_render(gauss)
    check_render("terrain 256x256 spp16 max_depth 6 gaussian (scan)", gauss,
                 img, scan_s, launches, bounces, queries, traced,
                 "tile_sweep", (0.005, 0.5))
    integrators.render(gauss, seed=0, spp=1, regen=True,
                       samples_per_pass=pool_lanes)  # warm-up
    film, pool_s, launches, counts = counted_pool(gauss, pool_lanes)
    g = check_pool("terrain 256x256 spp16 max_depth 6 gaussian (lane pool)",
                   gauss, film, pool_s, launches, counts, "tile_sweep",
                   (0.005, 0.5))
    scan = integrators.render(gauss, seed=0, develop_film=False)
    flips = films_equivalent(scan.cpu().numpy(), film.cpu().numpy(),
                             max_flips=64)
    # the splat's share of a profiled pool render: the device time launched
    # inside film_put (ert::film) over the run's busy device time
    prof_s, _prof, _events, summary = span_profile(
        lambda: integrators.render(gauss, seed=0, regen=True,
                                   samples_per_pass=pool_lanes,
                                   develop_film=False))
    busy_ms = summary["busy_s"] * 1e3
    g.update(scan_ms=scan_s * 1e3, flips_vs_scan=flips,
             box_scan_ms=box_ms["scan"], box_pool_ms=box_ms["pool"],
             splat_ms=span_ms(summary, "ert::film"), busy_ms=busy_ms,
             profiled_ms=prof_s * 1e3,
             splat_share=span_ms(summary, "ert::film") / busy_ms)
    print(f"# terrain gaussian 256x256 spp16: scan {scan_s * 1e3:.1f} ms, "
          f"lane pool {pool_s * 1e3:.1f} ms (the box film's: "
          f"{box_ms['scan']:.1f} and {box_ms['pool']:.1f} ms), films agree "
          f"({flips} pixels over tolerance, budget "
          f"64); splat {g['splat_ms']:.1f} device ms of a profiled pool "
          f"render's {busy_ms:.1f} busy ({prof_s * 1e3:.1f} ms; share "
          f"{g['splat_share']:.3f})", flush=True)
    rec["gaussian"] = g
    d4 = terrain_scene(V, F, 256, 256, 4, 6)
    del d4["camera"]["film"]["rfilter"]
    sc = load_dict(d4)
    rec["gaussian_value_grad"] = surface_value_grad(
        "terrain gaussian 256x256 spp4 max_depth 6", sc, pool_lanes,
        "tile_sweep", {"sun": spec_row(sc, int(
            sc.emitters["directional"]["irradiance"][0]))})
    # the splat and its adjoint on 2^20 random samples into 256x256
    gen = torch.Generator().manual_seed(25)
    n, H, W = 1 << 20, 256, 256
    pos = torch.rand(n, 2, generator=gen) * torch.tensor([W + 4.0, H + 4.0]) \
        - 2.0
    vals = torch.rand(n, 5, generator=gen)
    ct = torch.rand(H, W, 5, generator=gen)
    pos_d, vals_d, ct_d = pos.to(dev), vals.to(dev), ct.to(dev)
    put = lambda: films.film_put(torch.zeros(H, W, 5, device=dev), pos_d,
                                 vals_d, "gaussian")
    gat = lambda: films.film_gather(ct_d, pos_d, "gaussian")
    ref_put = films.film_put(torch.zeros(H, W, 5), pos, vals, "gaussian")
    ref_gat = films.film_gather(ct, pos, "gaussian")
    torch.testing.assert_close(put().cpu(), ref_put, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gat().cpu(), ref_gat, rtol=1e-5, atol=1e-6)
    put_ms, gat_ms = cuda_ms(put, reps=10), cuda_ms(gat, reps=10)
    iput_ms = cuda_ms(lambda: splat_index_put(
        torch.zeros(H, W, 5, device=dev), pos_d, vals_d, "gaussian"), reps=10)
    t0 = time.perf_counter()
    films.film_put(torch.zeros(H, W, 5), pos, vals, "gaussian")
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_taps = int(2 * 2.0 + 0.999) + 1
    put_b, put_by = splat_bound(n, H, W, n_taps)
    gat_b, gat_by = splat_bound(n, H, W, n_taps, gather=True)
    rec["splat"] = dict(
        put_ms=put_ms, put_index_put_ms=iput_ms, gather_ms=gat_ms,
        put_cpu_ms=plain_ms, put_bound_ms=put_b, put_bound_by=put_by,
        gather_bound_ms=gat_b, gather_bound_by=gat_by,
        put_max_abs_err=float((put().cpu() - ref_put).abs().max()),
        gather_max_abs_err=float((gat().cpu() - ref_gat).abs().max()))
    print(f"# gaussian splat, 2^20 samples into 256x256: film_put "
          f"(index_add_) {put_ms:.3f} ms, with index_put_(accumulate) "
          f"{iput_ms:.3f} ms, film_gather {gat_ms:.3f} ms; the CPU's "
          f"film_put {plain_ms:.0f} ms; bounds {put_b:.4f} ms ({put_by}) "
          f"and {gat_b:.4f} ms ({gat_by}); against the CPU: max abs err "
          f"{rec['splat']['put_max_abs_err']:.2e} (put), "
          f"{rec['splat']['gather_max_abs_err']:.2e} (gather)", flush=True)
    return rec


# chip_smoke.py phase 26's additions to the Cornell box (a copy of
# tests/test_torch_materials_render.py's add_materials: that module imports
# the JAX package)
CUBE_V = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                   [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                  np.float32)
CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                   [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                   [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)


def materials_cornell(width, height, spp, max_depth, res=64):
    """utils.scenes.cornell_box with a dielectric (bk7), a rough gold (GGX,
    alpha 0.2) and a rough dielectric (GGX, alpha 0.1) sphere, a
    12-triangle cube mesh under a Beckmann rough plastic (alpha 0.1) with
    a checkerboard diffuse reflectance (its uvs span [0.2, 0.8], off the
    checker's edges), the back wall under a bump map of an inline 64x64
    sinusoidal height and the floor under a normal map of an inline 64x64
    bitmap; all clear of the light."""
    from eradiate_kernel_tpu_torch.utils.scenes import cornell_box

    d = cornell_box(width, height, spp, max_depth)
    g = (np.arange(res, dtype=np.float32) + 0.5) / res
    u, v = np.meshgrid(g, g)
    height_map = 0.5 + 0.5 * np.sin(8 * np.pi * u) * np.sin(8 * np.pi * v)
    n = np.stack([0.3 * np.sin(6 * np.pi * u), 0.3 * np.cos(6 * np.pi * v),
                  np.ones_like(u)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    d["back"]["bsdf"] = {
        "type": "bumpmap", "scale": 0.05,
        "bumpmap": {"type": "bitmap", "data": height_map.astype(np.float32)},
        "nested": {"type": "ref", "id": "white_bsdf"}}
    d["floor"]["bsdf"] = {
        "type": "normalmap",
        "normalmap": {"type": "bitmap",
                      "data": (0.5 * n + 0.5).astype(np.float32)},
        "nested": {"type": "ref", "id": "white_bsdf"}}
    d["glass"] = {"type": "sphere", "center": [-0.5, -0.69, -0.3],
                  "radius": 0.3,
                  "bsdf": {"type": "dielectric", "int_ior": "bk7"}}
    d["gold"] = {"type": "sphere", "center": [0.5, -0.69, 0.4],
                 "radius": 0.3,
                 "bsdf": {"type": "roughconductor", "distribution": "ggx",
                          "alpha": 0.2, "material": "Au"}}
    d["frosted"] = {"type": "sphere", "center": [0.1, -0.74, -0.5],
                    "radius": 0.25,
                    "bsdf": {"type": "roughdielectric",
                             "distribution": "ggx", "alpha": 0.1}}
    d["cube"] = {
        "type": "mesh",
        "vertices": ((CUBE_V * 0.22) @ rot.T
                     + np.float32([-0.35, -0.77, 0.45])).astype(np.float32),
        "faces": CUBE_F, "uvs": 0.5 + 0.3 * CUBE_V[:, :2],
        "bsdf": {"type": "roughplastic", "distribution": "beckmann",
                 "alpha": 0.1,
                 "diffuse_reflectance": {"type": "checkerboard",
                                         "color0": [0.8, 0.3, 0.1],
                                         "color1": [0.1, 0.3, 0.8]}}}
    return d


def materials_terrain(V, F, width, height, spp, max_depth):
    """terrain_scene with uvs ((x + 1) / 2, (y + 1) / 2), a per-vertex
    colour from the height (a mesh attribute) and a blendbsdf whose weight
    is a checkerboard (0.2 / 0.8) over a plastic reading that colour and an
    anisotropic Beckmann rough conductor (alpha_u 0.1, alpha_v 0.4). As
    in the reference, only the diffuse BSDF hands a mesh_attribute its
    primitive: the plastic's base reads 0 (ROADMAP Queue 3)."""
    d = terrain_scene(V, F, width, height, spp, max_depth)
    s = (V[:, 2] - V[:, 2].min()) / (V[:, 2].max() - V[:, 2].min())
    d["terrain"]["uvs"] = 0.5 * (V[:, :2] + 1.0)
    d["terrain"]["attributes"] = {"vertex_color": np.stack(
        [0.2 + 0.6 * s, 0.5 - 0.2 * s, 0.8 - 0.6 * s], -1).astype(
            np.float32)}
    d["terrain"]["bsdf"] = {
        "type": "blendbsdf",
        "weight": {"type": "checkerboard", "color0": 0.2, "color1": 0.8},
        "base": {"type": "plastic", "diffuse_reflectance": {
            "type": "mesh_attribute", "name": "vertex_color"}},
        "metal": {"type": "roughconductor", "distribution": "beckmann",
                  "alpha_u": 0.1, "alpha_v": 0.4}}
    return d


def furnace_gate_scene(bsdf, width, spp, max_depth=48, rr_depth=1000,
                       shape="sphere"):
    """tests/test_bsdfs.py's furnace: a unit sphere (or the mask test's
    rectangle) under a constant environment of 1, seen from (0, 0, -4)."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth,
                       "rr_depth": rr_depth},
        "sensor": {"type": "perspective",
                   "to_world": {"type": "look_at", "origin": [0, 0, -4],
                                "target": [0, 0, 0], "up": [0, 1, 0]},
                   "film": {"type": "hdrfilm", "width": width,
                            "height": width, "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "object": ({"type": "sphere", "radius": 1.0, "bsdf": bsdf}
                   if shape == "sphere" else
                   {"type": "rectangle", "bsdf": bsdf}),
        "env": {"type": "constant", "radiance": 1.0},
    }


# tests/test_bsdfs.py:128-178: (bsdf, shape, max_depth, tolerance around 1)
FURNACE_GATES = {
    "conductor mirror": ({"type": "conductor"}, "sphere", 48, 0.01),
    "dielectric": ({"type": "dielectric"}, "sphere", 48, 0.01),
    "thindielectric": ({"type": "thindielectric"}, "sphere", 48, 0.01),
    "roughdielectric alpha 0.02": ({"type": "roughdielectric",
                                    "alpha": 0.02}, "sphere", 48, 0.02),
    "blend of diffuse and conductor": (
        {"type": "blendbsdf", "weight": 0.5,
         "a": {"type": "diffuse", "reflectance": 1.0},
         "b": {"type": "conductor"}}, "sphere", 48, 0.02),
    "flat normalmap": ({"type": "normalmap", "normalmap": [0.5, 0.5, 1.0],
                        "b": {"type": "diffuse", "reflectance": 1.0}},
                       "sphere", 48, 0.02),
    "mask pass-through rectangle": (
        {"type": "mask", "opacity": 0.5,
         "b": {"type": "twosided",
               "a": {"type": "diffuse", "reflectance": 1.0}}},
        "rectangle", 16, 0.03),
}


def materials_phases(V, F, lanes):
    """Phases 26-28 (slice 5c-1): Mitsuba's surface materials. The
    materials Cornell box on the lane pool (the fused sweep on its cube),
    with its value+grad through the path replay; the materials terrain(256)
    (the sorted sweep) through the scan driver and the pool; each against
    the plain sweep at 64x64; and the BSDF furnace gates. Returns the
    phases' records."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.scene import load_dict

    rec = {}

    # ---- 26. the materials Cornell box --------------------------------------
    phase_clock("26")
    # 256x256 spp 2 (phase 15's box takes 32; cut from 16 when phase 35 was
    # added, from 8 when phase 37 was, from 4 when phase 39 was): the time
    # limit; the cube is one tile: one fused tile_sweep launch a query
    box = load_dict(materials_cornell(256, 256, 2, 6))
    integrators.render(box, seed=0, spp=1, regen=True,
                       samples_per_pass=lanes)  # warm-up
    film, secs, launches, counts = counted_pool(box, lanes)
    rec["cornell"] = check_pool(
        "materials cornell box 256x256 spp2 max_depth 6 (lane pool)", box,
        film, secs, launches, counts, "tile_sweep", (0.05, 0.5))
    # 64x64 spp 2 max_depth 3 (spp 4 until phase 37 was added, max_depth 6
    # until phase 39 was)
    small = load_dict(materials_cornell(64, 64, 2, 3))
    film_k, _ = integrators.render_wavefront_regen(small, lanes, 3, 2)
    with intersect.use_plain():
        film_p, _ = integrators.render_wavefront_regen(small, lanes, 3, 2)
    flips = films_equivalent(film_p.cpu().numpy(), film_k.cpu().numpy(),
                             max_flips=2)
    rec["cornell"]["flips_vs_plain_64"] = flips
    print(f"# materials cornell box 64x64 spp2 max_depth 3: tile_sweep "
          f"kernel vs plain "
          f"films agree ({flips} pixels over tolerance, budget 2)",
          flush=True)
    # value+grad at 128x128 spp 1 (256x256 until phase 39 was added, spp 2
    # until phase 37 was): d(mean image)/d(spectra.baked.value)
    vg = load_dict(materials_cornell(128, 128, 1, 6))
    rows = materials_rows(vg)
    rec["cornell_value_grad"] = surface_value_grad(
        "materials cornell box 128x128 spp1 max_depth 6", vg, lanes,
        "tile_sweep", rows)
    # spp 4 until phase 37 was added, max_depth 6 until phase 39 was
    sc = load_dict(materials_cornell(64, 64, 2, 3))
    grads = {}
    t0 = time.perf_counter()
    for how, ctx in (("kernels", contextlib.nullcontext),
                     ("plain", intersect.use_plain)):
        with ctx():
            r, params = value_grad(sc, lanes, ["spectra.baked.value"],
                                   with_primal=False)
        grads[how] = params["spectra.baked.value"].grad
        for part in (r["forward"], r["backward"]):
            want = part["queries"] if how == "kernels" else 0
            assert part["queries"] > 0, (how, part)
            assert part["launches"]["tile_sweep"] == want, (how, part)
            assert sum(part["launches"].values()) == want, (how, part)
    g, ref = grads["kernels"], grads["plain"]
    ok = torch.isfinite(ref)
    assert torch.equal(ok, torch.isfinite(g))
    torch.testing.assert_close(g[ok], ref[ok], rtol=1e-5, atol=1e-7)
    rec["cornell_value_grad"]["grad_max_abs_err_vs_plain_64"] = float(
        (g[ok] - ref[ok]).abs().max())
    print(f"# materials cornell box 64x64 spp2 max_depth 3 value+grad: "
          f"tile_sweep vs "
          f"plain gradients agree (rtol 1e-5, atol 1e-7; max abs err "
          f"{rec['cornell_value_grad']['grad_max_abs_err_vs_plain_64']:.2e};"
          f" both legs {time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 27. the materials terrain(256): the sorted sweep -------------------
    phase_clock("27")
    terr = load_dict(materials_terrain(V, F, 256, 256, 16, 6))
    integrators.render(terr, seed=0, spp=1)  # warm-up
    img, scan_s, launches, bounces, queries, traced = counted_render(terr)
    check_render("materials terrain 256x256 spp16 max_depth 6 (scan)", terr,
                 img, scan_s, launches, bounces, queries, traced,
                 "tile_sweep", (0.005, 0.5))
    pool_lanes = 1 << 18
    integrators.render(terr, seed=0, spp=1, regen=True,
                       samples_per_pass=pool_lanes)  # warm-up
    film, pool_s, launches_p, counts = counted_pool(terr, pool_lanes)
    rec["terrain"] = check_pool(
        "materials terrain 256x256 spp16 max_depth 6 (lane pool)", terr,
        film, pool_s, launches_p, counts, "tile_sweep", (0.005, 0.5))
    scan = integrators.render(terr, seed=0, develop_film=False)
    # phase 17's budget: the scan splats a few samples into the next pixel
    flips = films_equivalent(scan.cpu().numpy(), film.cpu().numpy(),
                             max_flips=64)
    # max_depth 2 (6 until phase 39 was added, 3 until phase 40 was): the
    # plain sweep's time
    small = load_dict(materials_terrain(V, F, 64, 64, 4, 2))
    film_k = integrators.render(small, seed=3, develop_film=False)
    with intersect.use_plain():
        film_p = integrators.render(small, seed=3, develop_film=False)
    flips_plain = films_equivalent(film_p.cpu().numpy(),
                                   film_k.cpu().numpy(), max_flips=2)
    rec["terrain"].update(scan_ms=scan_s * 1e3, scan_launches=launches[
        "tile_sweep"], flips_vs_scan=flips, flips_vs_plain_64=flips_plain)
    print(f"# materials terrain 256x256 spp16: scan {scan_s * 1e3:.1f} ms, "
          f"lane pool {pool_s * 1e3:.1f} ms, films agree ({flips} pixels "
          f"over tolerance, budget 64); 64x64 spp4 max_depth 2 kernel vs "
          f"plain films agree ({flips_plain} pixels, budget 2)", flush=True)

    # ---- 28. the BSDF furnace gates -----------------------------------------
    phase_clock("28")
    gates = {}
    t0 = time.perf_counter()
    for label, (bsdf, shape, depth, tol) in FURNACE_GATES.items():
        sc = load_dict(furnace_gate_scene(bsdf, 32, 256, depth,
                                          shape=shape))
        with counting() as read:
            img = integrators.render(sc, seed=7, regen=True,
                                     samples_per_pass=lanes)
            assert sum(read()["launches"].values()) == 0, label
        assert bool(torch.isfinite(img).all()), label
        centre = float(img[12:20, 12:20].mean())
        gates[label] = centre
        assert abs(centre - 1.0) <= tol, (label, centre, tol)
    rec["gates"] = dict(gates, seconds=time.perf_counter() - t0)
    print(f"# BSDF furnace gates, 32x32 spp256 on the lane pool (centre "
          f"8x8 mean, 1 within tests/test_bsdfs.py's tolerance): "
          + ", ".join(f"{k} {v:.4f}" for k, v in gates.items())
          + f" ({rec['gates']['seconds']:.1f} s together)", flush=True)

    if "--profile" in sys.argv[1:]:
        profile_render(
            lambda: integrators.render(box, seed=0, regen=True,
                                       samples_per_pass=lanes),
            secs, "materials_cbox", window=lambda: integrators.render(
                box, seed=0, spp=4, regen=True, samples_per_pass=lanes))
        profile_render(
            lambda: integrators.render(terr, seed=0, regen=True,
                                       samples_per_pass=pool_lanes),
            pool_s, "materials_terrain_pool")
    return rec


def materials_rows(scene):
    """spectra.baked.value rows of the materials Cornell box by name: the
    cube's checkerboard colours, the gold's eta and k, the walls'
    reflectances."""
    a = {k: v.detach().cpu().numpy() for k, v in scene.tensors().items()}
    row = lambda spec: int(a["spec_slot"][spec])
    checker = a["tex_slot"][a["bsdfs.roughplastic.diffuse_reflectance"][0]]
    refl = a["bsdfs.diffuse.reflectance"]
    rows = {"checkerboard color0": row(a["textures.checkerboard.spec0"][
                checker]),
            "checkerboard color1": row(a["textures.checkerboard.spec1"][
                checker]),
            "gold eta": row(a["bsdfs.roughconductor.eta"][0]),
            "gold k": row(a["bsdfs.roughconductor.k"][0])}
    for name, tex in zip(("white", "red", "green"), refl[:3]):
        rows[name] = spec_row(scene, int(tex))
    return rows


def synth_measured_fields(T=6, L=16, res=32, seed=0):
    """A measured BRDF's fields in the layout of a ``.bsdf`` file (that of
    tests/test_measured.py's synth_fields): isotropic (one phi_i), T
    incident elevations, L wavelengths and res x res warp grids; a
    forward lobe that tightens with theta_i, zero on the first two
    theta_m columns (the pdf stays bounded near the specular direction),
    its widths and spectral scales drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    theta_i = np.linspace(0, np.pi / 2 * 0.95, T).astype(np.float32)
    u = np.linspace(0, 1, res)
    theta_m = u ** 2 * (np.pi / 2)
    window = np.ones(res)
    window[:2] = 0.0
    vndf = np.zeros((1, T, res, res), np.float32)
    lum = np.zeros((1, T, res, res), np.float32)
    phi_row = 1.0 + 0.3 * np.cos(2 * np.pi * u)[:, None]
    for t in range(T):
        alpha = (0.2 + 0.5 * t / max(T - 1, 1)) * rng.uniform(0.8, 1.2)
        lobe = (np.exp(-(theta_m / alpha) ** 2) * np.cos(theta_m)
                + 1e-3) * window
        vndf[0, t] = phi_row * lobe[None, :]
        lum[0, t] = phi_row * ((lobe + 1e-6) ** 0.8)[None, :] * window
    ndf = (np.exp(-(theta_m / 0.35) ** 2)[None, :].repeat(res, 0)
           + 1e-3).astype(np.float32)
    sigma = (0.25 + 0.5 * np.cos(theta_m)[None, :].repeat(res, 0)
             ).astype(np.float32)
    scale = np.sort(rng.uniform(0.3, 1.0, L))
    spectra = (vndf[:, :, None] * scale[None, None, :, None, None]
               ).astype(np.float32)
    return {"theta_i": theta_i, "phi_i": np.zeros(1, np.float32),
            "wavelengths": np.linspace(400, 700, L).astype(np.float32),
            "ndf": ndf, "sigma": sigma, "vndf": vndf, "luminance": lum,
            "spectra": spectra, "jacobian": np.ones(1, np.uint8)}


def sky_image(h=256, w=512, seed=0):
    """A smooth lat-long sky (rows from the emitter's +y pole to its -y
    pole) with a one-texel sun 10^4 times the sky's mean."""
    rng = np.random.default_rng(seed)
    theta = (np.arange(h) / (h - 1) * np.pi)[:, None, None]
    phi = (np.arange(w) / w * 2 * np.pi)[None, :, None]
    tint = rng.uniform(0.8, 1.2, 3)
    img = (0.25 + 0.15 * np.cos(theta) + 0.03 * np.sin(phi + rng.uniform(
        0, 2 * np.pi))) * tint
    img = img.astype(np.float32)
    img[int(rng.integers(h // 8, h // 3)), int(rng.integers(0, w))] = \
        1e4 * img.mean()
    return img


def measured_terrain(ply, fields, sky, width, height, spp, max_depth):
    """terrain(256) read from ``ply`` under a measured BRDF, lit by an
    envmap whose +y pole is the world's +z (no sun of its own), seen
    through the bench camera with the multijitter sampler."""
    d = terrain_scene(np.zeros((3, 3), np.float32),
                      np.zeros((1, 3), np.int32), width, height, spp,
                      max_depth)
    d["terrain"] = {"type": "ply", "filename": ply,
                    "bsdf": {"type": "measured", "fields": fields}}
    del d["sun"]
    d["sky"] = {"type": "envmap", "data": sky,
                "to_world": {"type": "rotate", "axis": [1, 0, 0],
                             "angle": 90.0}}
    d["camera"]["sampler"]["type"] = "multijitter"
    return d


def quadrics_box(width, height, spp, max_depth, seed=0):
    """utils.scenes.cornell_box with its area light replaced by a spot
    (down from the ceiling) and a projector (an inline 64x64 bitmap from
    ``seed``) and with a cylinder, a cone and a 12-triangle cube (one
    tile: the fused query) on the floor; the ldsampler sampler."""
    from eradiate_kernel_tpu_torch.utils.scenes import cornell_box

    rng = np.random.default_rng(seed)
    d = cornell_box(width, height, spp, max_depth)
    del d["light"]
    d["spot"] = {"type": "spot", "position": [0.0, 0.95, 0.0],
                 "direction": [0.0, -1.0, 0.1], "cutoff_angle": 50.0,
                 "beam_width": 35.0, "intensity": [6.0, 5.0, 4.0]}
    d["projector"] = {
        "type": "projector", "fov": 40.0,
        "to_world": {"type": "look_at", "origin": [-0.8, 0.8, -0.8],
                     "target": [0.2, -0.6, 0.5], "up": [0, 1, 0]},
        "irradiance": {"type": "bitmap", "data": (3.0 * rng.random(
            (64, 64, 3))).astype(np.float32)}}
    upright = {"type": "rotate", "axis": [1, 0, 0], "angle": -90.0}
    d["pipe"] = {"type": "cylinder", "radius": 0.15, "length": 0.9,
                 "to_world": [upright, {"type": "translate",
                                        "value": [-0.5, -1.0, 0.3]}],
                 "bsdf": {"type": "ref", "id": "white_bsdf"}}
    d["cone"] = {"type": "cone", "radius": 0.25, "length": 0.6,
                 "to_world": [upright, {"type": "translate",
                                        "value": [0.45, -1.0, -0.2]}],
                 "bsdf": {"type": "ref", "id": "red_bsdf"}}
    d["cube"] = {"type": "mesh",
                 "vertices": (CUBE_V * 0.2 + np.float32([0.0, -0.8, 0.5])
                              ).astype(np.float32),
                 "faces": CUBE_F, "bsdf": {"type": "ref", "id": "green_bsdf"}}
    d["sensor"]["sampler"] = {"type": "ldsampler", "sample_count": spp}
    return d


def kernel_vs_plain_grads(scene, lanes, keys, kernels):
    """value_grad of ``scene`` through the kernels and through the plain
    versions (intersect.use_plain): the gradients within rtol 1e-5, atol
    1e-7, each leg's launches one of ``kernels`` a query (the plain leg
    none). Returns the largest absolute difference."""
    from eradiate_kernel_tpu_torch.ops import intersect

    grads = {}
    for how, ctx in (("kernels", contextlib.nullcontext),
                     ("plain", intersect.use_plain)):
        with ctx():
            r, params = value_grad(scene, lanes, keys, with_primal=False)
        grads[how] = {k: p.grad for k, p in params.items()}
        for part in (r["forward"], r["backward"]):
            want = part["queries"] if how == "kernels" else 0
            assert part["queries"] > 0, (how, part)
            assert sum(part["launches"][k] for k in kernels) == want, \
                (how, part)
            assert sum(part["launches"].values()) == want, (how, part)
    worst = 0.0
    for k, g in grads["kernels"].items():
        ref = grads["plain"][k]
        ok = torch.isfinite(ref)
        assert torch.equal(ok, torch.isfinite(g)), k
        torch.testing.assert_close(g[ok], ref[ok], rtol=1e-5, atol=1e-7)
        worst = max(worst, float((g[ok] - ref[ok]).abs().max()))
    return worst


def slice_5c2_phases(V, F, scene, img, lanes):
    """Phases 29-32 (slice 5c-2): mesh files, the measured BSDF under an
    envmap sky, the lights-and-quadrics box and the samplers. ``scene``
    and ``img`` are phase 3's inline terrain and its film. Returns the
    phases' records."""
    from eradiate_kernel_tpu_torch import emitters, films, integrators
    from eradiate_kernel_tpu_torch.core import rng
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils import meshio

    rec = {}
    pool_lanes = 1 << 18
    out = os.path.join("smoke_out", "mesh_files")
    os.makedirs(out, exist_ok=True)

    # ---- 29. mesh files --------------------------------------------------------
    phase_clock("29")
    paths = {"ply": os.path.join(out, "terrain.ply"),
             "obj": os.path.join(out, "terrain.obj"),
             "serialized": os.path.join(out, "terrain.serialized")}
    t0 = time.perf_counter()
    meshio.write_ply(paths["ply"], V, F)
    write_obj(paths["obj"], V, F)
    write_serialized(paths["serialized"], V, F)
    rec["write_s"] = time.perf_counter() - t0
    base = scene.tensors()
    rec["files"] = {}
    for kind, path in paths.items():
        d = terrain_scene(V, F, 256, 256, 16, 6)
        d["terrain"] = {"type": kind, "filename": path,
                        "bsdf": d["terrain"]["bsdf"]}
        t0 = time.perf_counter()
        sc = load_dict(d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        # an OBJ numbers its vertices in order of first use: its vertex
        # and face arrays differ, its triangles, tiles (the packed rows'
        # views) and tables do not
        for name, t in sc.tensors().items():
            if kind == "obj" and name in ("geo.vertices", "geo.faces"):
                continue
            assert torch.equal(t, base[name]), (kind, name)
        assert torch.equal(sc.geo.vertices[sc.geo.faces.long()],
                           scene.geo.vertices[scene.geo.faces.long()]), kind
        film, secs, launches, bounces, queries, traced = counted_render(sc)
        check_render(f"terrain from {kind} 256x256 spp16 max_depth 6 "
                     "(scan)", sc, film, secs, launches, bounces, queries,
                     traced, "tile_sweep", (0.005, 0.5))
        assert torch.equal(film, img), f"{kind}: film differs from inline"
        rec["files"][kind] = dict(load_dict_s=load_s, render_ms=secs * 1e3,
                                  launches=launches["tile_sweep"],
                                  queries=queries)
    print("# mesh files: terrain(256) written in "
          f"{rec['write_s']:.2f} s; load_dict host seconds "
          + ", ".join(f"{k} {v['load_dict_s']:.2f}"
                      for k, v in rec["files"].items())
          + "; arrays and 256x256 spp16 films bit-equal to the inline "
          "mesh's", flush=True)
    # the forest with its crown read from an OBJ shapegroup child
    Vc, Fc = terrain(33)
    crown = os.path.join(out, "crown.obj")
    write_obj(crown, Vc, Fc)
    d = forest_scene(64, 64, 4, 2)
    d["grp"]["crown"] = {"type": "obj", "filename": crown,
                         "to_world": {"type": "scale", "value": 0.5},
                         "bsdf": {"type": "diffuse"}}
    t0 = time.perf_counter()
    fo = load_dict(d)
    torch.cuda.synchronize()
    rec["forest"] = dict(load_dict_s=time.perf_counter() - t0)
    inline = load_dict(forest_scene(64, 64, 4, 2))
    for name in ("tiles_v0", "tiles_e1", "tiles_e2", "tiles_prim",
                 "tiles_shape", "bvh_box", "bvh_meta", "bvh8_box",
                 "bvh8_meta", "inst_l2w"):
        a, b = getattr(fo.geo, name), getattr(inline.geo, name)
        same = (torch.equal(a.m, b.m) if name == "inst_l2w"
                else torch.equal(a, b))
        assert same, f"forest from obj: {name} differs"
    for name, wide in (("tile_bvh", "0"), ("tile_bvh8", "1")):
        with env(ERT_BVH_WIDE=wide):
            film, secs, launches, bounces, queries, traced = \
                counted_render(fo)
            ref = integrators.render(inline, seed=0)
        check_render(f"forest with an OBJ crown 64x64 spp4 max_depth 2 "
                     f"({name})", fo, film, secs, launches, bounces,
                     queries, traced, name, (0.005, 0.5))
        assert torch.equal(film, ref), f"forest from obj ({name}) differs"
        rec["forest"][name] = dict(launches=launches[name],
                                   queries=queries)
    print(f"# forest with an OBJ crown: load_dict "
          f"{rec['forest']['load_dict_s']:.2f} s, films through tile_bvh "
          f"and tile_bvh8 bit-equal to the inline crown's", flush=True)

    # ---- 30. the measured ground under an envmap sky ---------------------------
    phase_clock("30")
    fields = synth_measured_fields(6, 16, 32, seed=5)
    sky = sky_image(256, 512, seed=6)
    # spp 8 (16 until phase 37 was added): the time limit
    mt = load_dict(measured_terrain(paths["ply"], fields, sky, 256, 256, 8,
                                    6))
    integrators.render(mt, seed=0, spp=1)  # warm-up
    film, scan_s, launches, bounces, queries, traced = counted_render(mt)
    check_render("measured terrain under an envmap 256x256 spp8 max_depth "
                 "6 (scan)", mt, film, scan_s, launches, bounces, queries,
                 traced, "tile_sweep", (1e-3, 5.0))
    integrators.render(mt, seed=0, spp=1, regen=True,
                       samples_per_pass=pool_lanes)  # warm-up
    pfilm, pool_s, plaunches, counts = counted_pool(mt, pool_lanes)
    rec["measured"] = check_pool(
        "measured terrain under an envmap 256x256 spp8 max_depth 6 (lane "
        "pool)", mt, pfilm, pool_s, plaunches, counts, "tile_sweep",
        (1e-3, 5.0))
    scan = integrators.render(mt, seed=0, develop_film=False)
    flips = films_equivalent(scan.cpu().numpy(), pfilm.cpu().numpy(),
                             max_flips=64)
    # max_depth 2 (6 until phase 39 was added, 3 until phase 40 was): the
    # plain sweep's time
    small = load_dict(measured_terrain(paths["ply"], fields, sky, 64, 64, 4,
                                       2))
    film_k = integrators.render(small, seed=3, develop_film=False)
    with intersect.use_plain():
        film_p = integrators.render(small, seed=3, develop_film=False)
    flips_plain = films_equivalent(film_p.cpu().numpy(),
                                   film_k.cpu().numpy(), max_flips=2)
    rec["measured"].update(scan_ms=scan_s * 1e3, scan_launches=launches[
        "tile_sweep"], flips_vs_scan=flips, flips_vs_plain_64=flips_plain)
    print(f"# measured terrain: scan {scan_s * 1e3:.1f} ms, lane pool "
          f"{pool_s * 1e3:.1f} ms, films agree ({flips} pixels over "
          f"tolerance, budget 64); 64x64 spp4 max_depth 2 kernel vs plain "
          f"films agree ({flips_plain} pixels, budget 2)", flush=True)
    keys = ["emitters.envmap.image", "bsdfs.measured.spectra"]
    # spp 2 (4 until phase 37 was added)
    vg = load_dict(measured_terrain(paths["ply"], fields, sky, 256, 256, 2,
                                    6))
    r, params = value_grad(vg, pool_lanes, keys)
    for k, p in params.items():
        assert bool(torch.isfinite(p.grad).all()), f"{k} gradient"
        assert bool(p.grad.abs().sum() > 0), f"{k} gradient all zero"
    for part in (r["forward"], r["backward"]):
        la = part["launches"]
        assert la["tile_sweep"] == part["queries"] > 0, part
        assert sum(la.values()) == la["tile_sweep"], part
    r["grad_abs_sums"] = {k: float(p.grad.abs().sum())
                          for k, p in params.items()}
    # max_depth 2 (the films take 6; 3 until phase 39 was added): phase
    # 19's cut, the plain sweep's time through both legs
    r["grad_max_abs_err_vs_plain_64"] = kernel_vs_plain_grads(
        load_dict(measured_terrain(paths["ply"], fields, sky, 64, 64, 4, 2)),
        lanes, keys, ("tile_sweep",))
    rec["measured_value_grad"] = r
    print(f"# measured terrain under an envmap 256x256 spp2 value+grad: "
          f"primal {r['primal_ms']:.1f} ms, value+grad "
          f"{r['value_grad_ms']:.1f} ms ({r['value_grad_over_primal']:.2f}x"
          f"), launches forward {r['forward']['launches']['tile_sweep']} "
          f"backward {r['backward']['launches']['tile_sweep']} (= queries), "
          f"peak memory {r['peak_bytes'] / 2**20:.1f} MiB, |grad| sums "
          f"{r['grad_abs_sums']}; 64x64 spp4 max_depth 2 gradients "
          f"through the kernel vs plain (rtol 1e-5, atol 1e-7; max abs err "
          f"{r['grad_max_abs_err_vs_plain_64']:.2e})", flush=True)

    # ---- 31. the lights-and-quadrics box ---------------------------------------
    phase_clock("31")
    # spp 2 (16 until phase 37 was added, 8 until phase 39 was)
    box = load_dict(quadrics_box(256, 256, 2, 6))
    integrators.render(box, seed=0, spp=1, regen=True,
                       samples_per_pass=lanes)  # warm-up
    bfilm, box_s, blaunches, counts = counted_pool(box, lanes)
    rec["box"] = check_pool(
        "lights-and-quadrics box 256x256 spp2 max_depth 6 (lane pool)",
        box, bfilm, box_s, blaunches, counts, "tile_sweep", (0.01, 2.0))
    # threefry's share of a profiled spp 4 pool render's busy device time
    prof_s, _prof, _events, summary = span_profile(
        lambda: integrators.render(box, seed=0, spp=4, regen=True,
                                   samples_per_pass=lanes))
    rec["box"].update(profiled_ms_spp4=prof_s * 1e3,
                      busy_ms_spp4=summary["busy_s"] * 1e3,
                      threefry_share=span_ms(summary, "ert::rng")
                      / (summary["busy_s"] * 1e3))
    small = load_dict(quadrics_box(64, 64, 4, 6))
    film_k, _ = integrators.render_wavefront_regen(small, lanes, 3, 4)
    with intersect.use_plain():
        film_p, _ = integrators.render_wavefront_regen(small, lanes, 3, 4)
    rec["box"]["flips_vs_plain_64"] = films_equivalent(
        film_p.cpu().numpy(), film_k.cpu().numpy(), max_flips=2)
    vg = load_dict(quadrics_box(256, 256, 2, 6))
    a = {k: v.detach().cpu().numpy() for k, v in vg.tensors().items()}
    rows = {name: spec_row(vg, int(tex)) for name, tex in zip(
        ("white", "red", "green"), a["bsdfs.diffuse.reflectance"][:3])}
    rec["box_value_grad"] = surface_value_grad(
        "lights-and-quadrics box 256x256 spp2 max_depth 6", vg, lanes,
        "tile_sweep", rows)
    # emission rays of the box's spot and projector, card against CPU
    n = 1 << 20
    dev = box.bsphere_center.device
    cpu_box = load_dict(quadrics_box(256, 256, 8, 6), device="cpu")
    got = emitters.sample_emitter_ray(
        box, rng.Sampler.seed(7, torch.arange(n, device=dev)),
        torch.zeros(n, device=dev))
    want = emitters.sample_emitter_ray(
        cpu_box, rng.Sampler.seed(7, torch.arange(n)), torch.zeros(n))
    assert torch.equal(got[2].cpu(), want[2]), "emitter picks differ"
    err = 0.0
    for a_, b_ in ((got[0].o, want[0].o), (got[0].d, want[0].d),
                   (got[1], want[1])):
        torch.testing.assert_close(a_.cpu(), b_, rtol=1e-6, atol=1e-6)
        err = max(err, float((a_.cpu() - b_).abs().max()))
    rec["box"]["emitter_rays_max_abs_err"] = err
    print(f"# lights-and-quadrics box: 64x64 spp4 kernel vs plain films "
          f"agree ({rec['box']['flips_vs_plain_64']} pixels, budget 2); "
          f"a profiled spp4 pool render {prof_s * 1e3:.1f} ms: threefry "
          f"share of its busy device time "
          f"{rec['box']['threefry_share']:.3f}; "
          f"sample_emitter_ray on 2^20 lanes within 1e-6 of the CPU (max "
          f"abs err {err:.2e})", flush=True)

    # ---- 32. the samplers on the card ------------------------------------------
    phase_clock("32")
    rec["samplers"] = {}
    lane = (torch.arange(n, dtype=torch.int64) * 40503 + 2 ** 31) % 2 ** 32
    for kind in rng.SAMPLER_KINDS:
        draws = []
        for where in (dev, "cpu"):
            # spp 6: strata of 2 x 3, divisions that are not a power of 2
            smp = rng.Sampler.seed(11, lane.to(where), kind=kind, spp=6)
            seq = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for step in range(8):
                smp, u = smp.next_2d() if step % 2 else smp.next_1d()
                seq.append(u)
            torch.cuda.synchronize()
            if where == dev:
                rec["samplers"][kind] = dict(
                    ms_per_draw=(time.perf_counter() - t0) * 1e3 / 8)
            draws.append(seq)
        for g, c in zip(*draws):
            assert torch.equal(g.cpu(), c), f"{kind}: draws differ"
    print("# samplers: 2^20 lanes x 8 dimensions (next_1d, next_2d) "
          "bit-equal to the CPU, ms a draw on the card: "
          + ", ".join(f"{k} {v['ms_per_draw']:.3f}"
                      for k, v in rec["samplers"].items()), flush=True)
    return rec


def hg_table(g, n=181):
    """A Henyey-Greenstein phase function tabulated on n uniform cosines
    of the scattering angle (a tabphase's ``values``)."""
    mu = np.linspace(-1.0, 1.0, n)
    return ((1 - g * g) / (1 + g * g - 2 * g * mu) ** 1.5
            / (4 * np.pi)).tolist()


@contextlib.contextmanager
def walk_steps():
    """Inside the block, count the steps the transmittance walks of volpath
    (the NEE walk's and the MIS walk's) and of volpathmis (its two NEE
    walks) run."""
    from eradiate_kernel_tpu_torch.integrators import volpath, volpathmis

    steps = {"n": 0}
    run_walk = volpath._run_walk

    def counted_run_walk(body, *a, **kw):
        def step(s):
            steps["n"] += 1
            return body(s)
        return run_walk(step, *a, **kw)

    volpath._run_walk = volpathmis._run_walk = counted_run_walk
    try:
        yield steps
    finally:
        volpath._run_walk = volpathmis._run_walk = run_walk


def same_estimand(film, ref_film):
    """Two independent renders of one estimand: the mean of the per-pixel
    differences of the developed images within 3 standard errors of it
    (the spread of the differences over sqrt of their count). Returns the
    record."""
    from eradiate_kernel_tpu_torch.films import develop

    a = develop(film).double().cpu().numpy().ravel()
    b = develop(ref_film).double().cpu().numpy().ravel()
    d = a - b
    se = float(d.std(ddof=1) / np.sqrt(d.size))
    rec = dict(mean=float(a.mean()), ref_mean=float(b.mean()),
               mean_diff=float(d.mean()), std_err=se,
               z=float(d.mean()) / se)
    assert abs(rec["mean_diff"]) <= 3 * se, rec
    return rec


def films_vs_plain(scene, lanes, legs=("grid_gather", "tile_sweep")):
    """A lane-pool film of ``scene`` through the kernels and through the
    plain version of each kernel of ``legs``: films_equivalent with phase
    11's budget of 2 pixels. Returns the pixels over tolerance a leg."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.ops import gather, intersect

    plains = {"grid_gather": gather.use_plain,
              "tile_sweep": intersect.use_plain}
    spp = scene.config.spp
    film_k, _ = integrators.render_wavefront_regen(scene, lanes, 3, spp)
    flips = {}
    for name in legs:
        with plains[name]():
            film_p, _ = integrators.render_wavefront_regen(scene, lanes, 3,
                                                           spp)
        flips[name] = films_equivalent(film_p.cpu().numpy(),
                                       film_k.cpu().numpy(), max_flips=2)
    return flips


def grads_vs_plain(scene, lanes, keys,
                   legs=("grid_gather plain", "tile_sweep plain")):
    """value_grad of ``scene`` through the kernels (grid_gather's two
    forward entries counted apart, entry_counts) and through the plain
    versions of ``legs`` (the plain gather, the plain sweep): gradients
    within rtol 1e-5, atol 1e-7 (phase 14's tolerance), not all zero.
    Returns the kernel leg's record with "entries",
    "grad_max_abs_err_vs_plain" (a leg) and "grad_abs_sums"."""
    from eradiate_kernel_tpu_torch.ops import gather, intersect

    plains = {"grid_gather plain": gather.use_plain,
              "tile_sweep plain": intersect.use_plain}
    grads = {}
    for name, ctx in (("kernels", entry_counts),
                      *((leg, plains[leg]) for leg in legs)):
        with ctx() as entries:
            rec, params = value_grad(scene, lanes, keys, with_primal=False)
        if name == "kernels":
            kernel_rec = dict(rec, entries=dict(entries))
        grads[name] = {k: p.grad for k, p in params.items()}
    worst = {}
    for name in legs:
        worst[name] = 0.0
        for k, g in grads["kernels"].items():
            ref = grads[name][k]
            ok = torch.isfinite(ref)
            assert torch.equal(ok, torch.isfinite(g)), k
            assert bool(g[ok].abs().sum() > 0), k
            torch.testing.assert_close(g[ok], ref[ok], rtol=1e-5, atol=1e-7)
            worst[name] = max(worst[name],
                              float((g[ok] - ref[ok]).abs().max()))
    kernel_rec["grad_max_abs_err_vs_plain"] = worst
    kernel_rec["grad_abs_sums"] = {k: float(g.abs().sum())
                                   for k, g in grads["kernels"].items()}
    return kernel_rec


def nearest_bwd_load(grid, idx, gen):
    """The nearest lookup's backward (volumes.nearest_backward, the body
    of NearestGather.backward: the cotangents of ``idx``'s lanes
    index_add_-ed into a zero grid) on the card against the same call on
    the CPU (rtol 1e-5, atol 1e-7: the card's atomics add in no fixed
    order), timed. Returns the record."""
    from eradiate_kernel_tpu_torch.textures import volumes

    C = grid.shape[-1]
    V = grid.numel() // C
    ct = torch.randn(idx.shape[0], C, generator=gen).to(grid.device)
    backward = lambda: volumes.nearest_backward(ct, idx, V)
    d = backward()
    ref = volumes.nearest_backward(ct.cpu(), idx.cpu(), V)
    torch.testing.assert_close(d.cpu(), ref, rtol=1e-5, atol=1e-7)
    # bytes: the grid zeroed; each lane's index and cotangent read and its
    # row added into (read and written)
    nbytes = V * C * 4 + idx.shape[0] * (idx.element_size() + 3 * C * 4)
    bound_ms, bound_by = bound(nbytes, idx.shape[0] * C)
    return dict(ms=cuda_ms(backward, reps=50), bound_ms=bound_ms,
                bound_by=bound_by, lanes=idx.shape[0],
                max_abs_err=float((d.cpu() - ref).abs().max()),
                device_us=device_us(backward))


def slice_6a_launches(rec, kernel):
    """``kernel``'s launches in each render and value+grad of phase 33."""
    out = {f"large3d {k}": v["launches"][kernel]
           for k, v in rec["ablations"].items()}
    out["nearest 64^3"] = rec["nearest"]["launches"][kernel]
    out["aerosol atmosphere"] = rec["aerosol"]["launches"][kernel]
    for k, v in rec["value_grad"].items():
        out[f"{k} value+grad forward"] = v["forward"]["launches"][kernel]
        out[f"{k} value+grad backward"] = v["backward"]["launches"][kernel]
    return out


def slice_6a_phases(lanes, large_film, large_rec):
    """Phase 33 (slice 6a): bench.py's large3d under its ablations
    (nee_transmittance 'track', 'quadrature' with 8 nodes, ff_majorant
    'segment'), a nearest-filter 64^3 grid read from a .vol file, the
    flagship's profile atmosphere with an aerosol and measured spectra,
    and value+grad of the quadrature render and the nearest grid.
    ``large_film`` and ``large_rec`` are phase 10's residual large3d film
    and record. Returns the records."""
    from eradiate_kernel_tpu_torch.ops import gather
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.textures import volumes
    from eradiate_kernel_tpu_torch.utils import volfile
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    rec = {"ablations": {}}
    large_rec["lookup_points_a_step"] = (large_rec["lookup_points"]
                                         / large_rec["walk_steps"])

    def render(label, scene):
        with walk_steps() as steps:
            film, secs, launches, counts = counted_pool(scene, lanes)
        r = check_atmosphere(label, scene, film, secs, launches, counts)
        r["walk_steps"] = steps["n"]
        print(f"# {label}: walk steps {steps['n']}", flush=True)
        return film, r

    # (a) large3d (spp 2, bench.py 64: the time limit; cut from 4 when phase
    # 36 was added) under each ablation; films of 64x64 spp4 through the
    # kernels and the plain versions
    ablations = {"track": {"nee_transmittance": "track"},
                 "quadrature": {"nee_transmittance": "quadrature",
                                "nee_quad_points": 8},
                 "segment": {"nee_transmittance": "residual",
                             "ff_majorant": "segment"}}

    def large3d(width, spp, extra, max_depth=12):
        d = atmosphere(width, width, spp, max_depth, grid_res=(64, 64, 64))
        d["integrator"].update(extra)
        return d

    for name, extra in ablations.items():
        phase_clock(f"33a {name}")
        scene = load_dict(large3d(256, 2, extra))
        film, r = render(f"atmosphere 256x256 spp2 max_depth 12 grid 64^3, "
                         f"{name}", scene)
        assert r["lookups"] > 0 and r["nearest_lookups"] == 0, r
        r["vs_residual"] = same_estimand(film, large_film)
        r["vs_plain_64"] = films_vs_plain(
            load_dict(large3d(64, 4, extra)), lanes)
        r["lookup_points_a_step"] = r["lookup_points"] / r["walk_steps"]
        print(f"# large3d {name}: against phase 10's residual film "
              f"{r['vs_residual']}; 64x64 spp4 kernels vs plain "
              f"{r['vs_plain_64']} pixels over tolerance (budget 2); lookup "
              f"points a walk step {r['lookup_points_a_step']:.0f} (the "
              f"residual walk's {large_rec['lookup_points_a_step']:.0f})",
              flush=True)
        rec["ablations"][name] = r

    # (b) the 64^3 density written to a .vol file with its bbox, read back
    # nearest-filtered through use_grid_bbox
    phase_clock("33b")
    out = os.path.join("smoke_out", "vol")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "large3d_sigma_t.vol")

    def nearest(width, spp, max_depth=12):
        d = atmosphere(width, width, spp, max_depth, grid_res=(64, 64, 64))
        grid = d["atmo"]["interior"]["sigma_t"]
        volfile.write_vol(path, grid.pop("data"),
                          bbox=((-19.5, -19.5, 0.0), (20.5, 20.5, 1.0)))
        del grid["to_world"]
        grid.update(filename=path, use_grid_bbox=True,
                    filter_type="nearest")
        return d

    # spp 2 (bench.py: 64; cut from 4 when phase 36 was added)
    scene_b = load_dict(nearest(256, 2))
    assert scene_b.config.volume_kinds == ("gridvolume_nearest",
                                           "constvolume")
    film, r = render("atmosphere 256x256 spp2 max_depth 12 nearest 64^3 "
                     "from a .vol file", scene_b)
    assert r["nearest_lookups"] > 0 and r["lookups"] == 0, r
    assert r["launches"]["grid_gather"] == r["nearest_lookups"], r
    r["vs_plain_64"] = films_vs_plain(load_dict(nearest(64, 4)), lanes)
    # the gather entry on the render's table (the grid's (S*D*H*W, 1)
    # view) at 32,768 lanes of random points, beside index_select
    grid = scene_b.volumes["gridvolume_nearest"]["grid"]
    gen = torch.Generator().manual_seed(33)
    pl = torch.rand(lanes, 3, generator=gen).to(grid.device)
    idx = volumes._nearest_index(tuple(grid.shape[:4]),
                                 torch.zeros(lanes, dtype=torch.int32,
                                             device=grid.device), pl)
    r["gather_entry"] = gather_load(grid.reshape(-1, grid.shape[-1]), idx)
    r["nearest_backward"] = nearest_bwd_load(grid, idx, gen)
    g = r["gather_entry"]
    print(f"# nearest 64^3: 64x64 spp4 kernels vs plain {r['vs_plain_64']} "
          f"pixels over tolerance (budget 2); gather entry on the grid "
          f"({g['rows']} rows of {g['row_floats']} f32, {g['lanes']} lanes) "
          f"{g['ms']:.4f} ms, plain {g['plain_ms']:.4f} ms (bit-equal), "
          f"index_select {g['library_ms']:.4f} ms, bound "
          f"{g['bound_ms']:.5f} ms ({g['bound_by']}); device us a call "
          f"{g['device_us']}", flush=True)
    b = r["nearest_backward"]
    print(f"# nearest 64^3 backward (NearestGather: index_add_ of {b['lanes']}"
          f" lanes' cotangents): {b['ms']:.4f} ms by CUDA events "
          f"({b['device_us']} us device), against the CPU's within rtol "
          f"1e-5 (max abs err {b['max_abs_err']:.2e}), bound "
          f"{b['bound_ms']:.5f} ms ({b['bound_by']})", flush=True)
    rec["nearest"] = r

    # (c) the flagship's profile atmosphere with an aerosol (a blendphase,
    # weight 0.3, of Rayleigh and a 181-node table of HG g = 0.7), an
    # irregular ground reflectance and a 5800 K blackbody sun
    phase_clock("33c")

    def aerosol(width, spp):
        d = atmosphere(width, width, spp, 12, grid_res=64)
        d["atmo"]["interior"]["phase"] = {
            "type": "blendphase", "weight": 0.3,
            "rayleigh": {"type": "rayleigh"},
            "aerosol": {"type": "tabphase", "values": hg_table(0.7)}}
        d["surface"]["bsdf"]["rho_0"] = {
            "type": "irregular", "wavelengths": [400.0, 480.0, 560.0, 700.0],
            "values": [0.05, 0.12, 0.2, 0.35]}
        d["sun"]["irradiance"] = {"type": "blackbody", "temperature": 5800.0,
                                  "scale": 1e-4}
        return d

    scene_c = load_dict(aerosol(256, 2))  # spp 4 -> 2 with phase 36
    assert scene_c.config.het_profile1d
    _film, r = render("atmosphere 256x256 spp2 max_depth 12 grid 64, "
                      "aerosol blendphase, blackbody sun", scene_c)
    r["vs_plain_64"] = films_vs_plain(load_dict(aerosol(64, 4)), lanes,
                                      legs=("tile_sweep",))
    print(f"# aerosol atmosphere: 64x64 spp4 kernels vs plain "
          f"{r['vs_plain_64']} pixels over tolerance (budget 2)", flush=True)
    rec["aerosol"] = r

    # (d) value+grad at spp 2 of (a)'s quadrature render and of (b)
    phase_clock("33d")
    vg = {}
    # max_depth 6 (12 until phase 39 was added): the time limit
    for name, d_full, d_small, key in (
            # the 64x64 legs against the plain versions at max_depth 3 (4
            # until phase 41 was added, 6 until phase 40 was)
            ("quadrature", large3d(128, 2, ablations["quadrature"], 6),
             large3d(64, 2, ablations["quadrature"], 3),
             "volumes.gridvolume.grid"),
            ("nearest", nearest(128, 2, 6), nearest(64, 2, 3),
             "volumes.gridvolume_nearest.grid")):
        keys = [key, "volumes.constvolume.value"]
        scene = load_dict(d_full)
        r, params = value_grad(scene, lanes, keys)
        vg[name] = check_value_grad(
            f"atmosphere 128x128 spp2 max_depth 6 64^3 {name}", scene, r,
            params)
        bwd = r["backward"]["launches"]
        assert (bwd["grid_trilinear_bwd"] > 0) == (name == "quadrature"), r
        vg[name]["vs_plain_64"] = grads_vs_plain(
            load_dict(d_small), lanes, keys)["grad_max_abs_err_vs_plain"]
        print(f"# {name} 64x64 spp2 max_depth 3 value+grad: kernels vs "
              f"plain gradients "
              f"agree (rtol 1e-5, atol 1e-7; max abs err "
              f"{vg[name]['vs_plain_64']})", flush=True)
    rec["value_grad"] = vg
    return rec


def albedo_map(n=1024, seed=0):
    """A seeded n x n ground-albedo map: smooth rgb fields in [0.1, 0.5]
    with texel noise (float32)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 2 * np.pi, n)
    ph = rng.uniform(0, 2 * np.pi, (3, 2))
    img = np.stack([0.3 + 0.1 * np.sin(3 * x[:, None] + a)
                    * np.cos(5 * x[None, :] + b) for a, b in ph], -1)
    img += rng.normal(0.0, 0.05, img.shape)
    return np.clip(img, 0.1, 0.5).astype(np.float32)


def write_scene_xml(path, d, spp):
    """``d`` written by scene/xml.py::write_file, its sampler's spp turned
    into the parameter ``$spp`` with a <default> of ``spp``."""
    from eradiate_kernel_tpu_torch.scene import xml

    xml.write_file(path, d)
    with open(path) as f:
        text = f.read()
    tag = f'<integer name="sample_count" value="{spp}" />'
    assert tag in text
    text = text.replace(tag, '<integer name="sample_count" value="$spp" />')
    text = text.replace('<scene version="2.0.0">', '<scene version="2.0.0">\n'
                        f'  <default name="spp" value="{spp}" />', 1)
    with open(path, "w") as f:
        f.write(text)


def terrain_files(out, V, F, width, height, spp, albedo, sky):
    """Phase 34(a)'s scene, written under ``out``: terrain(256) as a PLY
    under a diffuse reflectance read from a ZIP EXR (f32), with a ground
    rectangle around it under the same BSDF (a PLY has no uvs, so the
    terrain reads the map's origin texel, as in the reference; the
    rectangle reads all of it), a sky from a PIZ EXR (f16) rotated so its
    +y pole is +z, a directional sun and the bench camera; the XML's spp
    is ``$spp``. Returns (XML path, the dict with the images inline as
    read back from the files, {file: seconds to write it})."""
    from eradiate_kernel_tpu_torch.utils import bitmap, meshio

    paths = {k: os.path.join(out, k) for k in
             ("terrain.ply", "albedo.exr", "sky.exr", "terrain.xml")}
    secs = {}
    t0 = time.perf_counter()
    meshio.write_ply(paths["terrain.ply"], V, F)
    secs["terrain.ply"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bitmap.write_exr(paths["albedo.exr"], albedo, compression="zip")
    secs["albedo.exr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bitmap.write_exr(paths["sky.exr"], sky, compression="piz",
                     pixel_type="f16")
    secs["sky.exr"] = time.perf_counter() - t0
    d = terrain_scene(np.zeros((3, 3), np.float32),
                      np.zeros((1, 3), np.int32), width, height, spp, 6)
    d = {"type": "scene",
         "albedo": {"type": "diffuse", "reflectance": {
             "type": "bitmap", "filename": paths["albedo.exr"]}},
         "terrain": {"type": "ply", "filename": paths["terrain.ply"],
                     "bsdf": {"type": "ref", "id": "albedo"}},
         "ground": {"type": "rectangle",
                    "to_world": [{"type": "scale", "value": [4.0, 4.0, 1.0]},
                                 {"type": "translate",
                                  "value": [0.0, 0.0, -0.6]}],
                    "bsdf": {"type": "ref", "id": "albedo"}},
         "sun": d["sun"],
         "sky": {"type": "envmap", "filename": paths["sky.exr"],
                 "scale": 0.5,
                 "to_world": {"type": "rotate", "axis": [1, 0, 0],
                              "angle": 90.0}},
         "camera": d["camera"], "integrator": d["integrator"]}
    t0 = time.perf_counter()
    write_scene_xml(paths["terrain.xml"], d, spp)
    secs["terrain.xml"] = time.perf_counter() - t0
    inline = dict(d)
    inline["albedo"] = {"type": "diffuse", "reflectance": {
        "type": "bitmap", "data": bitmap.read_exr(paths["albedo.exr"])[0]}}
    inline["sky"] = dict(d["sky"], data=bitmap.read_exr(
        paths["sky.exr"])[0])
    del inline["sky"]["filename"]
    return paths["terrain.xml"], inline, secs


def slice_7a_launches(rec, kernel):
    """``kernel``'s launches in each render of phase 34."""
    return {k: v["launches"][kernel] for k, v in rec["renders"].items()}


def slice_7a_phases(V, F, lanes, large_film):
    """Phase 34 (slice 7a): scenes loaded from files. (a) terrain(256)
    from a PLY, a ZIP EXR albedo map and a PIZ EXR sky, through the XML
    loader, its arrays bit-equal to the dict scene's with the images
    inline, rendered on a pool of 2^18 lanes, and its film saved to EXR,
    PFM and RGBE; (b) bench.py's large3d from XML with its grid in a .vol
    file, its film the same estimand as phase 10's; (c) the command line
    on the terrain XML, and runtime.render stopped after a pass and
    resumed from its checkpoint. ``large_film`` is phase 10's residual
    large3d film. Every file goes to a temporary directory. Returns the
    records."""
    import copy
    import tempfile

    from eradiate_kernel_tpu_torch import films, integrators
    from eradiate_kernel_tpu_torch.scene import load_dict, load_file, xml
    from eradiate_kernel_tpu_torch.utils import bitmap, runtime, volfile
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    rec = {"renders": {}}
    pool_lanes = 1 << 18

    def same_tensors(a, b, label):
        ta, tb = a.tensors(), b.tensors()
        assert ta.keys() == tb.keys(), label
        for name, t in tb.items():
            assert t.device.type == "cuda", (label, name)
            assert torch.equal(ta[name], t), (label, name)
        return len(ta)

    with tempfile.TemporaryDirectory() as out:
        # ---- 34a. the terrain from files ----------------------------------------
        phase_clock("34a")
        path, d_inline, secs = terrain_files(
            out, V, F, 256, 256, 16, albedo_map(1024, seed=7),
            sky_image(256, 512, seed=6))
        r = rec["terrain"] = {"write_s": secs}
        t0 = time.perf_counter()
        bitmap.read_exr(os.path.join(out, "albedo.exr"))
        bitmap.read_exr(os.path.join(out, "sky.exr"))
        r["read_exr_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene = load_file(path)
        torch.cuda.synchronize()
        r["load_file_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = load_dict(d_inline)
        torch.cuda.synchronize()
        r["load_dict_s"] = time.perf_counter() - t0
        assert scene.config == ref.config and scene.config.spp == 16
        r["tensors_bit_equal"] = same_tensors(scene, ref, "terrain")
        integrators.render(scene, seed=0, spp=1, regen=True,
                           samples_per_pass=pool_lanes)  # warm-up
        film, secs_p, launches, counts = counted_pool(scene, pool_lanes)
        pr = rec["renders"]["terrain from files pool"] = check_pool(
            "terrain from XML, PLY and EXR files 256x256 spp16 max_depth 6 "
            "(lane pool)", scene, film, secs_p, launches, counts,
            "tile_sweep", (1e-3, 5.0))
        film_d = integrators.render(ref, seed=0, regen=True,
                                    samples_per_pass=pool_lanes,
                                    develop_film=False)
        pr["flips_vs_dict"] = films_equivalent(
            film_d.cpu().numpy(), film.cpu().numpy(), max_flips=2)
        pr["bit_equal_to_dict"] = bool(torch.equal(film, film_d))
        img = films.develop(film).cpu().numpy()
        r["save"] = {}
        for ext in ("exr", "pfm", "hdr"):
            p = os.path.join(out, f"film.{ext}")
            t0 = time.perf_counter()
            films.save(p, film)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = bitmap.read_image(p)
            read_s = time.perf_counter() - t0
            assert back.shape == img.shape, (ext, back.shape)
            if ext == "hdr":  # shared exponents: within a step of the max
                pos = np.maximum(img, 0.0)
                err = float((np.abs(back - pos).max(-1)
                             / np.maximum(pos.max(-1), 1e-30)).max())
                assert err <= 2.0 ** -7, (ext, err)
            else:
                assert np.array_equal(back, img), ext
                err = 0.0
            r["save"][ext] = dict(save_s=save_s, read_s=read_s,
                                  bytes=os.path.getsize(p), rel_err=err)
        print(f"# 34a terrain from files: writes {secs} s; EXRs read back "
              f"{r['read_exr_s']:.2f} s; load_file {r['load_file_s']:.2f} "
              f"s, load_dict (images inline) {r['load_dict_s']:.2f} s, "
              f"{r['tensors_bit_equal']} tensors bit-equal; pool film vs the "
              f"dict scene's: {pr['flips_vs_dict']} pixels over tolerance "
              f"(budget 2; bit-equal {pr['bit_equal_to_dict']}); films.save "
              f"{r['save']}", flush=True)

        # ---- 34b. the 64^3 atmosphere from XML and a .vol file ----------------
        phase_clock("34b")
        d = atmosphere(256, 256, 4, 12, grid_res=(64, 64, 64))
        d["integrator"]["nee_transmittance"] = "residual"
        d["sensor"]["film"]["type"] = "hdrfilm"
        d_vol = copy.deepcopy(d)
        grid = d_vol["atmo"]["interior"]["sigma_t"]
        vol = os.path.join(out, "sigma_t.vol")
        apath = os.path.join(out, "large3d.xml")
        r = rec["large3d"] = {}
        t0 = time.perf_counter()
        volfile.write_vol(vol, grid.pop("data"))
        grid["filename"] = vol
        xml.write_file(apath, d_vol)
        r["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene_b = load_file(apath)
        torch.cuda.synchronize()
        r["load_file_s"] = time.perf_counter() - t0
        ref_b = load_dict(d)
        assert scene_b.config == ref_b.config
        assert scene_b.vol_packed is not None
        r["tensors_bit_equal"] = same_tensors(scene_b, ref_b, "large3d")
        # seed 1: independent of phase 10's film (seed 0), one estimand
        film_b, secs_b, launches, counts = counted_pool(scene_b, lanes,
                                                        seed=1)
        br = rec["renders"]["large3d from XML and .vol pool"] = \
            check_atmosphere("atmosphere 256x256 spp4 max_depth 12 grid 64^3 "
                             "from XML and a .vol file", scene_b, film_b,
                             secs_b, launches, counts)
        assert launches["grid_gather"] == counts["lookups"] > 0, counts
        br["vs_phase_10"] = same_estimand(film_b, large_film)
        print(f"# 34b large3d from files: written {r['write_s']:.2f} s, "
              f"load_file {r['load_file_s']:.2f} s, "
              f"{r['tensors_bit_equal']} tensors bit-equal to load_dict's; "
              f"against phase 10's film {br['vs_phase_10']}", flush=True)

        # ---- 34c. the command line and the pass runtime -----------------------
        phase_clock("34c")
        r = rec["cli"] = {}
        exr = os.path.join(out, "cli.exr")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "eradiate_kernel_tpu_torch", path, "-o",
             exr, "--regen", "-D", "spp=4"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        r["wall_s"] = time.perf_counter() - t0
        assert res.returncode == 0, res.stderr[-4000:]
        r["stderr"] = res.stderr.strip().splitlines()
        cli_img, names = bitmap.read_exr(exr)
        assert names == ["R", "G", "B"]
        scene4 = load_file(path, parameters={"spp": "4"})
        assert scene4.config.spp == 4
        film4 = integrators.render(scene4, seed=0, regen=True,
                                   develop_film=False)
        r["flips_vs_in_process"] = films_equivalent(
            films.develop(film4).cpu().numpy(), cli_img, max_flips=2)
        print(f"# 34c command line (--regen, spp 4): {r['wall_s']:.2f} s "
              f"wall, the import included ({r['stderr']}); its EXR vs the "
              f"in-process film: {r['flips_vs_in_process']} pixels over "
              f"tolerance (budget 2)", flush=True)

        class OnePass(runtime.RenderController):
            """Stops after the first pass."""

            def should_stop(self):
                return super().should_stop() or self.partial is not None

        r = rec["runtime"] = {"samples_per_pass": 1 << 16}
        ckpt = os.path.join(out, "render.ckpt")
        t0 = time.perf_counter()
        runtime.render(scene4, seed=0, samples_per_pass=1 << 16,
                       controller=OnePass(), checkpoint_path=ckpt,
                       develop_film=False)
        torch.cuda.synchronize()
        r["first_pass_s"] = time.perf_counter() - t0
        assert int(np.load(ckpt)["next_pass"]) == 1
        with counting() as read:
            t0 = time.perf_counter()
            resumed = runtime.render(scene4, seed=0, samples_per_pass=1 << 16,
                                     checkpoint_path=ckpt,
                                     develop_film=False)
            torch.cuda.synchronize()
            r["resume_s"] = time.perf_counter() - t0
            got = read()
        assert not os.path.exists(ckpt)
        launches = got["launches"]
        assert launches["tile_sweep"] == got["queries"] > 0, got
        assert sum(launches.values()) == launches["tile_sweep"], launches
        rec["renders"]["runtime.render resumed (3 of 4 passes)"] = dict(
            launches=launches, queries=got["queries"])
        whole = runtime.render(scene4, seed=0, samples_per_pass=1 << 16,
                               develop_film=False)
        assert float(resumed[..., 4].sum()) == 256 * 256 * 4
        r["flips_vs_uninterrupted"] = films_equivalent(
            whole.cpu().numpy(), resumed.cpu().numpy(), max_flips=2)
        print(f"# 34c runtime.render, 4 passes of 65,536 samples: stopped "
              f"after the first ({r['first_pass_s']:.2f} s) and resumed from "
              f"its checkpoint ({r['resume_s']:.2f} s; tile_sweep launches "
              f"{launches['tile_sweep']} = queries); vs the uninterrupted "
              f"film {r['flips_vs_uninterrupted']} pixels over tolerance "
              f"(budget 2)", flush=True)
    return rec


# chip_smoke.py phase 35's AOV spec (every camera-hit type but the uv
# partials, which keep the scan driver: phase 35d)
AOV_SPEC = ("dd:depth,pp:position,nn:geo_normal,sn:sh_normal,uv:uv,"
            "pi:prim_index,si:shape_index")


def aov_channels(film, names):
    """The {name: (H, W)} AOV images of a raw film: its channels after the
    5 base ones over the weight (render(return_aovs=True)'s)."""
    w = torch.clamp(film[..., 4:5], min=1e-12)
    return {name: (film[..., 5 + i] / w[..., 0])
            for i, name in enumerate(names)}


def stacked(aovs, names):
    """The (H, W, len(names)) stack of the named AOV images, as numpy."""
    return torch.stack([aovs[n] for n in names], -1).cpu().numpy()


def scan_moved_pixels(scene, seed, spp):
    """(H, W) bool numpy: the pixels where the scan driver's film and the
    lane pool's differ by construction. The scan driver splats a sample at
    its jittered position, pixel + jitter in float32, which rounds up to
    the next pixel when the jitter is within half an ulp of 1; the pool
    writes it to its sample's own pixel. Marks both pixels of every such
    sample; returns (mask, samples moved)."""
    from eradiate_kernel_tpu_torch import integrators

    cfg = scene.config
    W, H = cfg.film_width, cfg.film_height
    dev = scene.bsphere_center.device
    sample = torch.arange(W * H * spp, device=dev)
    pos = integrators._camera_lanes(scene, seed, spp, sample)[3]
    own = sample // spp
    lands = (torch.clamp(pos[:, 1].long(), 0, H - 1) * W
             + torch.clamp(pos[:, 0].long(), 0, W - 1))
    moved = lands != own
    mask = torch.zeros(H * W, dtype=torch.bool, device=dev)
    mask[own[moved]] = True
    mask[lands[moved]] = True
    return mask.reshape(H, W).cpu().numpy(), int(moved.sum())


def aov_drivers_agree(a, b, moved):
    """Two drivers' camera-hit AOVs of one scene agree within 1e-5 of
    max(|value|, 1) but in 2 pixels, a group of channels (depth; position;
    uv, both normals and the shape index), and the prim index is equal but
    in 2 pixels, outside the pixels ``moved`` (scan_moved_pixels). Returns
    the pixels over tolerance a group."""
    keep = ~moved
    groups = {"depth": ["dd"], "position": ["pp.x", "pp.y", "pp.z"],
              "uv, normals, shape": ["uv.x", "uv.y", "nn.x", "nn.y", "nn.z",
                                     "sn.x", "sn.y", "sn.z", "si"]}
    out = {k: films_equivalent(stacked(a, v)[keep], stacked(b, v)[keep], 2,
                               tol=1e-5) for k, v in groups.items()}
    out["prim index"] = int(((a["pi"] != b["pi"]).cpu().numpy()
                             & keep).sum())
    assert out["prim index"] <= 2, out
    return out


def slice_6b_launches(rec, kernel):
    """``kernel``'s launches in each render of phase 35."""
    return {k: v["launches"][kernel] for k, v in rec["renders"].items()}


def slice_6b_phases(V, F, lanes, refs):
    """Phase 35 (slice 6b): volpathmis and the AOV wrappers at full width.
    (a) the flagship under volpathmis on the lane pool (spp 2, seed 1),
    beside volpath's render of the same spp and seed: time, Msamples/s,
    iterations, host syncs, walk steps, peak memory, tile_sweep launches ==
    queries; its film the same estimand as phase 9's. (b) large3d under
    volpathmis (spp 2, seed 1), beside volpath's: grid_gather launches ==
    lookups > 0, its film the same estimand as phase 10's, a 64x64 spp4
    film through the kernels against the plain gather and the plain sweep.
    (c) aov (seven camera-hit types) over path on phase 3's terrain(256)
    (spp 16) through the scan driver and a pool of 2^18 lanes: the base
    films equal phase 3's and phase 17's, the AOVs of the two drivers
    agree, tile_sweep launches == the child's queries + the AOV queries
    (one a pass, one a refill); a 64x64 spp4 pool render through the
    kernel and the plain sweep: depth bit-equal, every AOV bit-equal where
    the prim index is. (d) duv_dx and duv_dy on the terrain, 64x64 spp4,
    scan driver: finite, non-zero on hit pixels. (e) moment over volpath
    on the flagship pool (spp 2, seed 1): its base film bit-equal to (a)'s
    volpath film, the second moment >= the squared mean. (f) films.save
    of (c)'s pool film and AOVs to EXR, read back bit for bit under the
    reference's names. ``refs``: phase 3's terrain image and queries,
    phase 9's and 10's films, phase 17's terrain pool film and queries.
    Returns the records."""
    import tempfile

    from eradiate_kernel_tpu_torch import films, integrators
    from eradiate_kernel_tpu_torch.integrators import aov
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils import bitmap
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    rec = {"renders": {}}
    pool_lanes = 1 << 18

    # spp 2 (bench.py: 64; cut from 4 when phase 36 was added)
    spp = 2

    def atmo_dict(grid_res, kind="volpath"):
        d = atmosphere(256, 256, spp, 12, grid_res=grid_res)
        d["integrator"]["nee_transmittance"] = "residual"
        d["integrator"]["type"] = kind
        return d

    def atmo_pair(label, grid_res, ref_film):
        """volpath and volpathmis renders of one atmosphere at spp 2, seed
        1: each one's record, volpathmis's against ``ref_film``."""
        out = {}
        for kind in ("volpath", "volpathmis"):
            scene = load_dict(atmo_dict(grid_res, kind))
            torch.cuda.reset_peak_memory_stats()
            with walk_steps() as steps:
                film, secs, launches, counts = counted_pool(scene, lanes,
                                                            seed=1)
            r = rec["renders"][f"{label} {kind}"] = check_atmosphere(
                f"{label} 256x256 spp{spp} max_depth 12 {kind} (seed 1)",
                scene, film, secs, launches, counts)
            r.update(walk_steps=steps["n"],
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     launches_per_sample=launches["tile_sweep"]
                     / (256 * 256 * spp),
                     queries_per_iteration=counts["queries"]
                     / counts["iterations"])
            out[kind] = (scene, film)
        r["vs_volpath_spp64_seed0"] = same_estimand(film, ref_film)
        v = rec["renders"][f"{label} volpath"]
        print(f"# 35 {label}: volpathmis {r['render_ms']:.1f} ms against "
              f"volpath's {v['render_ms']:.1f} ms ("
              f"{r['render_ms'] / v['render_ms']:.2f}x); walk steps "
              f"{r['walk_steps']} against {v['walk_steps']}; tile_sweep "
              f"launches a sample {r['launches_per_sample']:.4f} against "
              f"{v['launches_per_sample']:.4f}, queries an iteration "
              f"{r['queries_per_iteration']:.2f} against "
              f"{v['queries_per_iteration']:.2f}; peak memory "
              f"{r['peak_bytes'] / 2**20:.1f} MiB against "
              f"{v['peak_bytes'] / 2**20:.1f} MiB; against the volpath film "
              f"at spp 64 (seed 0): {r['vs_volpath_spp64_seed0']}",
              flush=True)
        return out

    # ---- 35a. volpathmis on the flagship ---------------------------------------
    phase_clock("35a")
    flag = atmo_pair("flagship", 64, refs["flagship film"])
    assert rec["renders"]["flagship volpathmis"]["lookups"] == 0  # einsum

    # ---- 35b. volpathmis on large3d ---------------------------------------------
    phase_clock("35b")
    atmo_pair("large3d", (64, 64, 64), refs["large3d film"])
    r = rec["renders"]["large3d volpathmis"]
    assert r["launches"]["grid_gather"] == r["lookups"] > 0, r
    small = load_dict(dict(atmosphere(64, 64, 4, 12,
                                      grid_res=(64, 64, 64)),
                           integrator={"type": "volpathmis",
                                       "max_depth": 12}))
    r["flips_vs_plain_64"] = films_vs_plain(small, lanes)
    print(f"# 35b large3d volpathmis 64x64 spp4: kernels vs plain films "
          f"agree ({r['flips_vs_plain_64']} pixels over tolerance, budget "
          f"2)", flush=True)

    # ---- 35c. aov over path on terrain(256) ---------------------------------
    phase_clock("35c")
    d = terrain_scene(V, F, 256, 256, 16, 6)
    d["integrator"] = {"type": "aov", "aovs": AOV_SPEC,
                       "child": d["integrator"]}
    scene = load_dict(d)
    names = integrators.aov_names(scene.config)
    refills = {"n": 0}
    refill_aov = aov._refill_aov

    def counted_refill(*a, **kw):
        refills["n"] += 1
        return refill_aov(*a, **kw)

    aov._refill_aov = counted_refill
    try:
        with counting() as read:
            t0 = time.perf_counter()
            img_s, aovs_s = integrators.render(scene, seed=0,
                                               return_aovs=True)
            torch.cuda.synchronize()
            scan_s = time.perf_counter() - t0
            got = read()
        n_passes = 1  # 1,048,576 samples: one pass of the scan driver
        sr = rec["renders"]["terrain aov scan"] = dict(
            render_ms=scan_s * 1e3, launches=got["launches"],
            queries=got["queries"])
        assert got["launches"]["tile_sweep"] == got["queries"] \
            == refs["terrain queries"] + n_passes, (got, refs)
        sr["flips_vs_phase_3"] = films_equivalent(
            refs["terrain image"].cpu().numpy(), img_s.cpu().numpy(), 2)
        integrators.render(scene, seed=0, spp=1, regen=True,
                           samples_per_pass=pool_lanes)  # warm-up
        refills["n"] = 0
        film_p, pool_s, launches, counts = counted_pool(scene, pool_lanes)
        pr = rec["renders"]["terrain aov pool"] = check_pool(
            "terrain aov over path 256x256 spp16 max_depth 6 (lane pool)",
            scene, film_p, pool_s, launches, counts, "tile_sweep",
            (0.005, 0.5))
        pr["refill_queries"] = refills["n"]
        assert counts["queries"] == refs["terrain pool queries"] \
            + refills["n"], (counts, refs["terrain pool queries"])
        pr["flips_vs_phase_17"] = films_equivalent(
            refs["terrain pool film"].cpu().numpy(),
            film_p[..., :5].cpu().numpy(), 2)
        # the refill queries' device time: kernels launched inside a query
        # inside the pool's refill (the camera hit of _refill_aov)
        _s, _prof, events, _summary = span_profile(
            lambda: integrators.render(scene, seed=0, regen=True,
                                       samples_per_pass=pool_lanes,
                                       develop_film=False))
        pr["refill_ms"] = 1e3 * sum(spans.kernels_inside(
            events, "ert::pool.refill", "ert::query").values())
    finally:
        aov._refill_aov = refill_aov
    aovs_p = aov_channels(film_p, names)
    moved, pr["scan_samples_moved"] = scan_moved_pixels(scene, 0, 16)
    pr["scan_moved_pixels"] = int(moved.sum())
    pr["pixels_over_vs_scan"] = aov_drivers_agree(aovs_s, aovs_p, moved)
    # 64x64 spp4 max_depth 3 (6 until phase 40 was added: the plain
    # sweep's time) on the pool: through the kernel and the plain sweep
    d64 = terrain_scene(V, F, 64, 64, 4, 3)
    d64["integrator"] = {"type": "aov", "aovs": AOV_SPEC,
                         "child": d64["integrator"]}
    small = load_dict(d64)
    film_k, _ = integrators.render_wavefront_regen(small, lanes, 3, 4)
    with intersect.use_plain():
        film_q, _ = integrators.render_wavefront_regen(small, lanes, 3, 4)
    pr["flips_vs_plain_64"] = films_equivalent(
        film_q[..., :5].cpu().numpy(), film_k[..., :5].cpu().numpy(), 2)
    ak, aq = aov_channels(film_k, names), aov_channels(film_q, names)
    assert torch.equal(ak["dd"], aq["dd"])
    same_prim = ak["pi"] == aq["pi"]
    pr["prim_ties_vs_plain_64"] = int((~same_prim).sum())
    assert pr["prim_ties_vs_plain_64"] <= 2, pr["prim_ties_vs_plain_64"]
    for name in names:
        assert torch.equal(ak[name][same_prim], aq[name][same_prim]), name
    print(f"# 35c terrain aov 256x256 spp16: scan {scan_s * 1e3:.1f} ms "
          f"(tile_sweep launches {sr['queries']} = phase 3's "
          f"{refs['terrain queries']} + {n_passes} AOV query; base image vs "
          f"phase 3's: {sr['flips_vs_phase_3']} pixels over tolerance, "
          f"budget 2); pool {pool_s * 1e3:.1f} ms (launches "
          f"{counts['queries']} = phase 17's {refs['terrain pool queries']}"
          f" + {pr['refill_queries']} refill queries taking "
          f"{pr['refill_ms']:.1f} device ms "
          f"(profiled); base film vs phase 17's: "
          f"{pr['flips_vs_phase_17']} pixels, budget 2); AOVs scan vs pool: "
          f"pixels over 1e-5 {pr['pixels_over_vs_scan']} (budget 2 each) "
          f"outside the {pr['scan_moved_pixels']} pixels of the "
          f"{pr['scan_samples_moved']} samples the scan splats into the "
          f"next pixel; 64x64 spp4 kernel "
          f"vs plain sweep: films {pr['flips_vs_plain_64']} pixels over "
          f"tolerance, AOVs bit-equal (prim ties "
          f"{pr['prim_ties_vs_plain_64']})", flush=True)

    # ---- 35d. the uv partials on the terrain ------------------------------------
    phase_clock("35d")
    d64 = terrain_scene(V, F, 64, 64, 4, 6)
    d64["integrator"] = {"type": "aov", "aovs": "d1:duv_dx,d2:duv_dy,"
                         "si:shape_index", "child": d64["integrator"]}
    duv_scene = load_dict(d64)
    assert not integrators.regen_supported(duv_scene.config)
    with counting() as read:
        _img, aovs_d = integrators.render(duv_scene, seed=0,
                                          return_aovs=True)
        got = read()
    assert got["launches"]["tile_sweep"] == got["queries"] > 0, got
    duv = torch.stack([aovs_d[k] for k in ("d1.x", "d1.y", "d2.x", "d2.y")],
                      -1)
    hit = aovs_d["si"] == 0  # every sample of the pixel hit the terrain
    assert bool(torch.isfinite(duv).all()) and bool(hit.any())
    assert bool((duv[hit][:, :2].abs().sum(-1) > 0).all())
    assert bool((duv[hit][:, 2:].abs().sum(-1) > 0).all())
    rec["duv"] = dict(hit_pixels=int(hit.sum()),
                      median_abs=duv[hit].abs().median(0).values.tolist(),
                      launches=got["launches"]["tile_sweep"])
    rec["renders"]["terrain duv 64x64 scan"] = dict(launches=got["launches"])
    print(f"# 35d duv_dx, duv_dy 64x64 spp4 (scan driver): finite, non-zero "
          f"on the {rec['duv']['hit_pixels']} hit pixels (median |duv| "
          f"{rec['duv']['median_abs']}); tile_sweep launches "
          f"{rec['duv']['launches']} = queries", flush=True)

    # ---- 35e. moment over volpath on the flagship ------------------------------
    phase_clock("35e")
    dm = atmo_dict(64)
    dm["integrator"] = {"type": "moment", "child": dm["integrator"]}
    mscene = load_dict(dm)
    film_m, secs_m, launches, counts = counted_pool(mscene, lanes, seed=1)
    mr = rec["renders"]["flagship moment over volpath"] = check_atmosphere(
        f"flagship moment over volpath 256x256 spp{spp} max_depth 12 "
        "(seed 1)",
        mscene, film_m, secs_m, launches, counts)
    base = flag["volpath"][1]
    # the wrapper draws nothing: the child's samples are the same, so the
    # film is too (bit for bit unless the wider slot buffer's spp sum
    # associates differently: then within 1e-6, no pixel over)
    mr["base_bit_equal_to_volpath"] = bool(torch.equal(film_m[..., :5],
                                                       base))
    films_equivalent(base.cpu().numpy(), film_m[..., :5].cpu().numpy(), 0,
                     tol=1e-6)
    m2 = aov_channels(film_m, ["m2.x", "m2.y", "m2.z"])
    w = torch.clamp(film_m[..., 4], min=1e-12)
    worst = 0.0
    for i, c in enumerate("xyz"):
        mean = film_m[..., i] / w
        gap = m2[f"m2.{c}"] - mean * mean
        # equality (one sample value in the pixel) within an ulp
        assert bool((gap >= -1e-6 * mean * mean).all()), c
        worst = min(worst, float(gap.min()))
    mr["min_variance"] = worst
    print(f"# 35e moment over volpath: {mr['render_ms']:.1f} ms; base film "
          f"against volpath's of the same seed: bit-equal "
          f"{mr['base_bit_equal_to_volpath']}; m2 - mean^2 >= 0 in every "
          f"pixel (least {worst:.3e})", flush=True)

    # ---- 35f. films.save of the AOV film -----------------------------------------
    phase_clock("35f")
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "aov.exr")
        films.save(path, film_p, aovs=aovs_p)
        back, got_names = bitmap.read_exr(path)
    assert sorted(got_names) == sorted(["R", "G", "B"] + names), got_names
    written = dict(zip(["R", "G", "B"], np.moveaxis(
        films.develop(film_p).cpu().numpy(), -1, 0)))
    written.update({k: v.cpu().numpy() for k, v in aovs_p.items()})
    for i, name in enumerate(got_names):
        assert np.array_equal(back[..., i], written[name]), name
    rec["exr_channels"] = got_names
    print(f"# 35f films.save: {len(got_names)} channels {got_names} read "
          f"back bit-equal", flush=True)
    return rec


# phase 36's batch size: the batches that estimate per-sample variances,
# and the kernel-vs-plain film of (a)
S36_BATCH = 1 << 14


def slice_6c1_launches(rec, kernel):
    """``kernel``'s launches in each render of phase 36."""
    return {k: v["launches"][kernel] for k, v in rec["renders"].items()}


def y_of(film):
    """Y of a raw 1x1 film: its Y channel over its weight."""
    return float(film[..., 1].sum() / film[..., 4].sum())


def y_batches(scene, lanes, spp, n=8, seed0=1000, column=None):
    """n independent lane-pool renders of ``scene`` at ``spp`` (seeds
    seed0 .. seed0 + n - 1) -> the per-sample variance of Y (or, with
    ``column``, of column(film)) estimated from the spread of the batch
    values: var = var(batch values) x spp."""
    from eradiate_kernel_tpu_torch import integrators

    vals = []
    for k in range(n):
        film = integrators.render(scene, seed=seed0 + k, spp=spp, regen=True,
                                  samples_per_pass=lanes, develop_film=False)
        vals.append(column(film) if column else y_of(film))
    return float(np.var(vals, ddof=1)) * spp


def z_of(a, b, var_a, n_a, var_b, n_b):
    """(z, standard error) of a - b for independent estimates of per-sample
    variances var_a, var_b over n_a, n_b samples."""
    se = float(np.sqrt(var_a / n_a + var_b / n_b))
    return (a - b) / se, se


def srgb_albedo_grid(n, seed=1):
    """An aerosol's chromatic single-scattering albedo: an n^3 rgb grid in
    [0.5, 0.95] from numpy's seed ``seed``, bluish (more scattering at short
    wavelengths), smooth in z."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 0.95, (n, n, n, 3))
    tint = np.asarray([0.85, 0.9, 1.0])
    z = (np.arange(n) + 0.5) / n
    grid = 0.5 + (base * tint - 0.5) * (1.0 - 0.3 * z)[:, None, None, None]
    return np.clip(grid, 0.5, 0.95).astype(np.float32)


@contextlib.contextmanager
def entry_counts():
    """Inside the block, count the launches of grid_gather's two forward
    entries apart: ``trilinear`` (grid_trilinear) and ``gather``
    (_gather_cuda). Yields the counts."""
    from eradiate_kernel_tpu_torch.ops import gather

    n = {"trilinear": 0, "gather": 0}
    fns = (gather.grid_trilinear, gather._gather_cuda)

    def tri(*a, **kw):
        n["trilinear"] += 1
        return fns[0](*a, **kw)

    def rows(*a, **kw):
        n["gather"] += 1
        return fns[1](*a, **kw)

    gather.grid_trilinear, gather._gather_cuda = tri, rows
    try:
        yield n
    finally:
        gather.grid_trilinear, gather._gather_cuda = fns


def slice_6c1_phases(lanes, large_rec):
    """Phase 36 (slice 6c-1): the spectral variant at full size. (a)
    bench.py's spectral load (BENCH_SCENE=spectral: the flagship atmosphere
    under a 1x1 distant sensor, 262,144 samples, max_depth 12, residual
    NEE, seed 1, 32,768 lanes) in spectral and in rgb: time, Msamples/s,
    iterations, host syncs, peak memory, tile_sweep launches == queries;
    the grey scene's Y the same in both within 3 standard errors; spp
    16,384 through the kernel and the plain sweep within 1e-5. (b) bins
    over volpath (five bins over 360-830 nm) at spp 65,536: the base film
    bit-equal to volpath's, the bins' sum / 470 the base film's Y within 3
    standard errors; one nbins line finite and > 0. (c) srf sensors at spp
    65,536: a flat 360-830 nm srf the estimand of (a), a narrow triangular
    one finite and > 0. (d) a chromatic 64^3 atmosphere (large3d at spp 2
    with a 32^3 srgb albedo grid, packed at load as gridvolume_srgb): the
    rgb2spec fit's host time, fused-entry launches == trilinear lookups,
    gather-entry launches == srgb lookups (a volume_eval, of sigma_t or of
    the albedo, sweeps both grid kinds), 64x64 spp4 films through the
    kernels against the plain gather and the plain sweep, and the gather
    entry on the 32-float packed rows beside index_select. ``large_rec``:
    phase 10's large3d record. Returns the records."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    rec = {"renders": {}}
    dev = torch.device("cuda")
    n_load = 1 << 18  # bench.py :90-93 at its 256x256x64 budget
    n_batch = S36_BATCH  # the batches that estimate the variances

    def load(variant, spp=n_load, integrator=None, sensor=None):
        d = atmosphere(spp=spp, max_depth=12, grid_res=64, sensor="distant")
        d["integrator"]["nee_transmittance"] = "residual"
        if integrator is not None:
            d["integrator"] = dict(integrator, child=d["integrator"])
        if sensor is not None:
            d["sensor"].update(sensor)
        return load_dict(d, Variant(variant))

    def timed(label, scene, seed=1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        film, secs, launches, counts = counted_pool(scene, lanes, seed=seed)
        cfg = scene.config
        r = rec["renders"][label] = check_pool(
            f"{label} spp {cfg.spp} max_depth 12 grid 64 (seed {seed})",
            scene, film[..., :5], secs, launches, counts, "tile_sweep",
            (1e-4, 2.0))
        r.update(peak_bytes=torch.cuda.max_memory_allocated(),
                 launches_per_sample=launches["tile_sweep"] / cfg.spp,
                 y=y_of(film))
        return film

    # ---- 36a. bench.py's spectral load, and rgb -------------------------
    phase_clock("36a")
    spectral, rgb = load("spectral"), load("rgb")
    assert spectral.config.variant.is_spectral
    integrators.render(spectral, seed=0, spp=1 << 12, regen=True,
                       samples_per_pass=lanes)  # warm-up
    film_s = timed("spectral distant 1x1", spectral)
    REF_FILMS["spectral distant film"] = film_s  # phase 37 holds to it
    film_r = timed("rgb distant 1x1", rgb)
    var_s = y_batches(spectral, lanes, n_batch)
    var_r = y_batches(rgb, lanes, n_batch)
    rs = rec["renders"]["spectral distant 1x1"]
    rr = rec["renders"]["rgb distant 1x1"]
    n_s, n_r = spectral.config.spp, rgb.config.spp
    z, se = z_of(rs["y"], rr["y"], var_s, n_s, var_r, n_r)
    rs["same_estimand_as_rgb"] = dict(y=rs["y"], rgb_y=rr["y"], std_err=se,
                                      z=z, var_spectral=var_s, var_rgb=var_r)
    assert abs(z) <= 3, rs["same_estimand_as_rgb"]
    # spp 16,384 through the kernel and the plain sweep
    film_k, _ = integrators.render_wavefront_regen(spectral, lanes, 3,
                                                   n_batch)
    with intersect.use_plain():
        film_p, _ = integrators.render_wavefront_regen(spectral, lanes, 3,
                                                       n_batch)
    rel = float(((film_k - film_p).abs() / film_p.abs().clamp(min=1e-12))
                .max())
    assert rel <= 1e-5, rel
    rs["vs_plain_sweep"] = dict(max_rel=rel,
                                bit_equal=bool(torch.equal(film_k, film_p)))
    print(f"# 36a bench.py's spectral load (distant 1x1, 262,144 samples): "
          f"spectral {rs['render_ms']:.1f} ms ({rs['msamples_per_s']:.3f} "
          f"Msamples/s, {rs['iterations']} iterations, host syncs "
          f"{rs['host_syncs']}, tile_sweep launches a sample "
          f"{rs['launches_per_sample']:.5f}, peak memory "
          f"{rs['peak_bytes'] / 2**20:.1f} MiB) against rgb "
          f"{rr['render_ms']:.1f} ms ({rr['msamples_per_s']:.3f} Msamples/s,"
          f" {rr['iterations']} iterations, host syncs {rr['host_syncs']}, "
          f"launches a sample {rr['launches_per_sample']:.5f}, peak memory "
          f"{rr['peak_bytes'] / 2**20:.1f} MiB); Y {rs['y']:.6f} against "
          f"{rr['y']:.6f}: z = {z:.2f} (standard error {se:.2e}); spp 16,384 "
          f"kernel vs plain sweep: max rel {rel:.1e}, bit-equal "
          f"{rs['vs_plain_sweep']['bit_equal']}", flush=True)

    # ---- 36b. bins and nbins over volpath ---------------------------------
    phase_clock("36b")
    n_b = 1 << 16
    bins_spec = {"type": "bins",
                 "bins": "b1:360:455,b2:455:550,b3:550:645,b4:645:740,"
                         "b5:740:830"}
    bscene = load("spectral", spp=n_b, integrator=bins_spec)
    names = integrators.aov_names(bscene.config)
    film_b = timed("bins over volpath", bscene)
    plain = load("spectral", spp=n_b)
    film_v, _secs, _l, _c = counted_pool(plain, lanes, seed=1)
    rb = rec["renders"]["bins over volpath"]
    rb["base_bit_equal_to_volpath"] = bool(torch.equal(film_b[..., :5],
                                                       film_v))
    assert rb["base_bit_equal_to_volpath"]

    def bins_gap(film):
        w = float(film[..., 4].sum())
        return float(film[..., 5:].sum()) / w / 470.0 - y_of(film)

    gap = bins_gap(film_b)
    var_gap = y_batches(bscene, lanes, n_batch // 2, column=bins_gap)
    se = float(np.sqrt(var_gap / bscene.config.spp))
    rb["bins_sum_vs_y"] = dict(gap=gap, std_err=se, z=gap / se,
                               bins={n: float(film_b[..., 5 + i].sum()
                                              / film_b[..., 4].sum())
                                     for i, n in enumerate(names)})
    assert abs(gap) <= 3 * se, rb["bins_sum_vs_y"]
    nscene = load("spectral", spp=n_b, integrator={
        "type": "nbins", "bins": "l550:550", "tolerance": 25.0})
    film_n = timed("nbins over volpath", nscene)
    line = float(film_n[..., 5].sum() / film_n[..., 4].sum())
    assert np.isfinite(line) and line > 0, line
    rec["renders"]["nbins over volpath"]["l550"] = line
    print(f"# 36b bins over volpath spp 65,536: {rb['render_ms']:.1f} ms; "
          f"base film bit-equal to volpath's: True; bins "
          f"{rb['bins_sum_vs_y']['bins']}: sum / 470 - Y = {gap:.2e} (z = "
          f"{gap / se:.2f}); nbins l550 (tolerance 25) {line:.5f}",
          flush=True)

    # ---- 36c. srf sensors --------------------------------------------------
    phase_clock("36c")
    flat = load("spectral", spp=n_b, sensor={"srf": {
        "type": "regular", "lambda_min": 360.0, "lambda_max": 830.0,
        "values": [1.0, 1.0]}})
    film_f = timed("flat srf", flat)
    rf = rec["renders"]["flat srf"]
    z, se = z_of(rf["y"], rs["y"], var_s, flat.config.spp, var_s, n_s)
    rf["same_estimand_as_36a"] = dict(y=rf["y"], ref_y=rs["y"], z=z,
                                      std_err=se)
    assert abs(z) <= 3, rf["same_estimand_as_36a"]
    tri = load("spectral", spp=n_b, sensor={"srf": {
        "type": "regular", "lambda_min": 640.0, "lambda_max": 690.0,
        "values": [0.0, 1.0, 0.0]}})
    film_t = timed("triangular srf 640-690", tri)
    rt = rec["renders"]["triangular srf 640-690"]
    assert np.isfinite(rt["y"]) and rt["y"] > 0, rt["y"]
    print(f"# 36c srf sensors spp 65,536: flat 360-830 {rf['render_ms']:.1f}"
          f" ms, Y {rf['y']:.6f} against 36a's {rs['y']:.6f} (z = {z:.2f});"
          f" triangular 640-690 {rt['render_ms']:.1f} ms, Y {rt['y']:.6f}",
          flush=True)
    del film_f, film_t, film_n, film_b, film_v

    # ---- 36d. a chromatic 64^3 atmosphere --------------------------------
    phase_clock("36d")
    albedo = srgb_albedo_grid(32)
    n_alb = albedo.shape[0]
    t0 = time.perf_counter()
    # spp 2 (4 until phase 39 was added; phase 10's rgb large3d takes 4)
    cscene = load_dict(chromatic_atmosphere(256, 256, 2), Variant("spectral"))
    load_s = time.perf_counter() - t0
    assert "gridvolume_srgb" in cscene.config.volume_kinds
    packed = cscene.vol_packed_spectral["gridvolume_srgb"]
    assert packed.shape == (n_alb ** 3, 32), packed.shape
    # the rgb2spec fit alone, on the host (load_dict's share of load_s)
    from eradiate_kernel_tpu_torch.utils.rgb2spec import fit_srgb_coeff_batch
    scale = np.maximum(2.0 * albedo.max(-1), 1e-8)
    t0 = time.perf_counter()
    fit_srgb_coeff_batch((albedo / scale[..., None]).reshape(-1, 3))
    fit_s = time.perf_counter() - t0
    integrators.render(cscene, seed=0, spp=1, regen=True,
                       samples_per_pass=lanes)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    with entry_counts() as entries:
        film_c, secs, launches, counts = counted_pool(cscene, lanes)
    rc = rec["renders"]["chromatic 64^3"] = check_atmosphere(
        "chromatic 64^3 atmosphere 256x256 spp2 max_depth 12 (spectral, "
        "32^3 srgb albedo)", cscene, film_c, secs, launches, counts)
    rc.update(entries=dict(entries), load_s=load_s, fit_s=fit_s,
              albedo_voxels=n_alb ** 3,
              peak_bytes=torch.cuda.max_memory_allocated(),
              vs_rgb_large3d_ms=large_rec["render_ms"])
    # one fused launch a trilinear lookup, one gather launch an srgb
    # lookup; a volume_eval (of sigma_t or of the albedo) runs the lookup
    # of each grid kind of the scene over its lanes (the reference's
    # masked sweep over kinds), so both count every volume_eval
    assert entries["trilinear"] == counts["lookups"] > 0, (entries, counts)
    assert entries["gather"] == counts["srgb_lookups"] > 0, (entries, counts)
    assert launches["grid_gather"] == sum(entries.values()), launches
    small = load_dict(chromatic_atmosphere(64, 64, 4), Variant("spectral"))
    rc["flips_vs_plain_64"] = films_vs_plain(small, lanes)
    # the gather entry on the packed srgb rows (32 floats) beside
    # index_select, at the pool's lane count
    gen = torch.Generator().manual_seed(36)
    idx = torch.randint(0, packed.shape[0], (lanes,), generator=gen,
                        dtype=torch.int32).to(dev)
    rc["gather_entry_32f"] = gather_load(packed, idx)
    g = rc["gather_entry_32f"]
    print(f"# 36d chromatic 64^3 spp2: {rc['render_ms']:.1f} ms against "
          f"phase 10's rgb large3d at spp 4 {large_rec['render_ms']:.1f} ms; "
          f"fused "
          f"launches {entries['trilinear']} (= trilinear lookups), "
          f"gather-entry launches {entries['gather']} (= srgb lookups: each "
          f"volume_eval, of sigma_t or of the albedo, sweeps both grid "
          f"kinds); load_dict "
          f"{load_s:.2f} s, of it the rgb2spec fit of {n_alb ** 3} voxels "
          f"{fit_s:.2f} s; peak memory {rc['peak_bytes'] / 2**20:.1f} MiB; "
          f"64x64 spp4 kernels vs plain {rc['flips_vs_plain_64']} (budget 2);"
          f" gather entry on {g['rows']} rows x {g['row_floats']} f32, "
          f"{g['lanes']} lanes: {g['ms']:.4f} ms, plain {g['plain_ms']:.4f} "
          f"ms (bit-equal), index_select {g['library_ms']:.4f} ms, bound "
          f"{g['bound_ms']:.5f} ms ({g['bound_by']}); device us a call "
          f"{g['device_us']}", flush=True)
    del film_s, film_r, film_k, film_p, film_c
    return rec


# phase 37's spectral grid: S bands over [S37_LAMBDA]
S37_BANDS = 8
S37_LAMBDA = (400.0, 800.0)


def slice_6c2_launches(rec, kernel):
    """``kernel``'s launches in each render and value+grad of phase 37
    (a value+grad's forward and adjoint apart)."""
    out = {k: v["launches"][kernel] for k, v in rec["renders"].items()}
    for k, v in rec["value_grads"].items():
        for part in ("forward", "backward"):
            out[f"{k} {part}"] = v[part]["launches"][kernel]
    return out


def chromatic_atmosphere(width, height, spp, spectral_sigma=False,
                         max_depth=12):
    """Phase 36d's chromatic 64^3 atmosphere (large3d, max_depth 12,
    residual NEE, the seeded 32^3 rgb albedo); with ``spectral_sigma`` its
    sigma_t a gridvolume_spectral of S37_BANDS bands over S37_LAMBDA: the
    64^3 density times (550 / lambda)^2, Rayleigh-like."""
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(width, height, spp, max_depth, grid_res=(64, 64, 64))
    d["integrator"]["nee_transmittance"] = "residual"
    med = d["atmo"]["interior"]
    tw = med["sigma_t"]["to_world"]
    med["albedo"] = {"type": "gridvolume", "data": srgb_albedo_grid(32),
                     "to_world": tw}
    if spectral_sigma:
        lam = np.linspace(*S37_LAMBDA, S37_BANDS)
        med["sigma_t"] = {
            "type": "gridvolume_spectral", "to_world": tw,
            "data": (med["sigma_t"]["data"][..., None]
                     * (550.0 / lam) ** 2).astype(np.float32),
            "lambda_min": S37_LAMBDA[0], "lambda_max": S37_LAMBDA[1]}
    return d


def check_grid_launches(label, rec):
    """Hold a value+grad of grid lookups to its counts: forward and
    adjoint, one tile_sweep launch a closest-hit query and one grid_gather
    launch a lookup (the fused entry a trilinear lookup, the gather entry
    an srgb lookup); one grid_trilinear_bwd launch a trilinear lookup of
    the adjoint and none in the forward; no BVH kernel."""
    fwd, bwd, ent = rec["forward"], rec["backward"], rec["entries"]
    for part in (fwd, bwd):
        la = part["launches"]
        assert la["tile_sweep"] == part["queries"] > 0, (label, part)
        assert la["grid_gather"] == part["lookups"] + part[
            "srgb_lookups"] + part["nearest_lookups"], (label, part)
        assert la["tile_bvh"] == la["tile_bvh8"] == 0, (label, part)
    assert fwd["launches"]["grid_trilinear_bwd"] == 0, (label, fwd)
    assert bwd["launches"]["grid_trilinear_bwd"] == bwd["lookups"] > 0, \
        (label, bwd)
    assert ent["trilinear"] == fwd["lookups"] + bwd["lookups"], (label, ent)
    assert ent["gather"] == fwd["srgb_lookups"] + bwd["srgb_lookups"] > 0, \
        (label, ent)


def slice_6c2_phases(V, F, lanes, s6c1):
    """Phase 37 (slice 6c-2): the spectral variant's gradients, volpathmis,
    the AOV wrappers, the measured BSDF and emitter rays in spectral, at
    full size. (a) bench.py's spectral load (phase 36a's: 1x1 distant,
    262,144 samples; the value+grad at seed 0): value+grad of the image
    mean with respect to the atmosphere's sigma_t on the lane pool (the
    path replay; its film bit-equal to the primal's) and on the scan
    driver (autograd through passes as wide as the pool), the two
    gradients within rtol 5e-3, atol 1e-7 (the reference's
    tests/test_autodiff.py:348 figure); times, host syncs, peak memory.
    (b) phase 36d's chromatic 64^3 at 64x64 spp 2 max_depth 6: value+grad
    with respect to the 64^3 sigma_t and the 32^3 srgb albedo through the
    kernels and
    through the plain gather and the plain sweep (rtol 1e-5, atol 1e-7);
    fused-entry launches == trilinear lookups, gather-entry launches ==
    srgb lookups, grid_trilinear_bwd launches == the adjoint's trilinear
    lookups (C = 1). (c) the same with sigma_t a gridvolume_spectral of
    S37_BANDS bands, through the kernels and the plain gather:
    grid_trilinear_bwd at C = S37_BANDS on the path (its time a call:
    phase 13). (d) on (a)'s load, moment over volpath (its
    base film bit-equal to phase 36a's film; its m2.y the per-sample
    variance of Y) and moment over volpathmis: volpathmis's Y within 3
    standard errors of volpath's; aov (depth, shading normal) over
    volpath on terrain(256) at 256x256 spp 4 on the pool (tile_sweep
    launches == queries, the refills' AOV queries included). (e) phase
    30's measured terrain (the PLY of phase 29, a 128x256 sky) in
    spectral at 64x64 spp 4 max_depth 3 through the kernel against the
    plain sweep (budget 2); sample_emitter_ray in spectral over 2^16
    lanes (an area
    light of a uniform spectrum, a blackbody sun, an srgb point light and
    a d65 sky) against the same call on the CPU: the picks equal, o and
    d within 1e-4, wavelengths 1e-5 and weights 1e-4 relative (the card's
    sin, cos and exp are ulps from the CPU's; each kind's largest
    difference is printed). ``s6c1``: phase 36's
    records. Returns the records."""
    from eradiate_kernel_tpu_torch import emitters, integrators
    from eradiate_kernel_tpu_torch.core import rng
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.films import develop
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.textures import volumes
    from eradiate_kernel_tpu_torch.utils import autodiff
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    rec = {"renders": {}, "value_grads": {}}
    spectral = Variant("spectral")
    n_load = 1 << 18
    primal = s6c1["renders"]["spectral distant 1x1"]

    def distant(integrator=None, spp=n_load):
        d = atmosphere(spp=spp, max_depth=12, grid_res=64,
                       sensor="distant")
        d["integrator"]["nee_transmittance"] = "residual"
        if integrator is not None:
            d["integrator"] = integrator
        return load_dict(d, spectral)

    # ---- 37a. value+grad on bench.py's spectral load ---------------------
    phase_clock("37a")
    key = "volumes.gridvolume.grid"
    scene = distant()
    r, params = value_grad(scene, lanes, [key])
    g_pool = params[key].grad
    rec["value_grads"]["spectral distant pool"] = r
    # the scan driver: autograd through its passes, each as wide as the
    # pool. A sample's float operations are the same on both drivers only
    # at one batch width: cuBLAS picks its kernel by the shape, and the
    # einsum lookup's rows round differently at another width (recorded
    # below), which flips a free-flight decision now and then
    gen = torch.Generator().manual_seed(37)
    pts = torch.rand(2 * lanes, 3, generator=gen).to(scene.geo.tiles_v0.device)
    slot = torch.zeros(2 * lanes, dtype=torch.int32, device=pts.device)
    grid = scene.volumes["gridvolume"]["grid"]
    rec["einsum_rows_batch_invariant"] = bool(torch.equal(
        volumes._trilinear_einsum(grid, slot, pts)[:lanes],
        volumes._trilinear_einsum(grid, slot[:lanes], pts[:lanes])))
    pm = autodiff.traverse(scene).keep([key])
    p_scan = pm.trainable()
    with counting() as read:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        film = integrators.render(pm.with_trainable(p_scan), seed=0,
                                  samples_per_pass=lanes,
                                  develop_film=False)
        loss = develop(film).mean()
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd = read()
        loss.backward()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        end = read()
    bwd = {k: ({kk: vv - fwd[k][kk] for kk, vv in v.items()}
               if isinstance(v, dict) else v - fwd[k])
           for k, v in end.items()}
    g_scan = p_scan[key].grad
    for g in (g_pool, g_scan):
        assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
    rec["voxels_off_tolerance"] = int(
        (~torch.isclose(g_pool, g_scan, rtol=5e-3, atol=1e-7)).sum())
    rec["scan_vs_pool_film_sums"] = [
        a - b for a, b in zip(film.detach().sum((0, 1)).tolist(),
                              r["film_sums"])]
    print(f"# 37a diagnostics: einsum rows batch-invariant "
          f"{rec['einsum_rows_batch_invariant']}; scan - pool film sums "
          f"{rec['scan_vs_pool_film_sums']}; gradient |max| "
          f"{float(g_pool.abs().max()):.3e}, voxels off rtol 5e-3 / atol "
          f"1e-7: {rec['voxels_off_tolerance']}, max abs diff "
          f"{float((g_pool - g_scan).abs().max()):.3e}", flush=True)
    torch.testing.assert_close(g_pool, g_scan, rtol=5e-3, atol=1e-7)
    rs = rec["value_grads"]["spectral distant scan"] = dict(
        value_grad_ms=total_s * 1e3, forward_ms=fwd_s * 1e3,
        backward_ms=(total_s - fwd_s) * 1e3, forward=fwd, backward=bwd,
        peak_bytes=torch.cuda.max_memory_allocated(),
        loss=float(loss.detach()),
        pool_vs_scan_max_abs_err=float((g_pool - g_scan).abs().max()),
        grad_abs_sum=float(g_pool.abs().sum()))
    r["over_phase_36a_primal"] = r["value_grad_ms"] / primal["render_ms"]
    # autograd's backward of the scan replays nothing: no query, no launch
    # (the einsum lookup's backward is a matmul)
    assert fwd["launches"]["tile_sweep"] == fwd["queries"] > 0, fwd
    assert sum(bwd["launches"].values()) == bwd["queries"] == 0, bwd
    print(f"# 37a value+grad of bench.py's spectral load (262,144 "
          f"samples) with respect to sigma_t: pool (path replay) "
          f"{r['value_grad_ms']:.1f} ms (forward {r['forward_ms']:.1f}, "
          f"backward {r['backward_ms']:.1f}; "
          f"{r['value_grad_over_primal']:.2f}x its primal "
          f"{r['primal_ms']:.1f} ms, {r['over_phase_36a_primal']:.2f}x "
          f"phase 36a's; film bit-equal to the primal's), iterations "
          f"{r['forward']['forward_iterations']} + "
          f"{r['backward']['adjoint_iterations']}, host syncs "
          f"{r['forward']['host_syncs']} + {r['backward']['host_syncs']} "
          f"(+ the pool's {r['forward']['pool_syncs']} + "
          f"{r['backward']['pool_syncs']}), peak memory "
          f"{r['peak_bytes'] / 2**20:.1f} MiB; scan driver "
          f"{rs['value_grad_ms']:.1f} ms (forward {rs['forward_ms']:.1f}, "
          f"backward {rs['backward_ms']:.1f}), host syncs "
          f"{fwd['host_syncs']} + {bwd['host_syncs']}, peak memory "
          f"{rs['peak_bytes'] / 2**20:.1f} MiB; gradients agree (rtol "
          f"5e-3, atol 1e-7; max abs err {rs['pool_vs_scan_max_abs_err']:.2e}"
          f" of |grad| sum {rs['grad_abs_sum']:.3e})", flush=True)
    del film, loss, pm, p_scan, params

    # ---- 37b-c. the chromatic 64^3: value+grad of both grids --------------
    # (c) holds the gather against its plain version (its point: the
    # backward at C = S37_BANDS); the cube's sweep is (b)'s
    for tag, spectral_sigma, sigma_key, C, legs in (
            ("37b", False, "volumes.gridvolume.grid", 1,
             ("grid_gather plain", "tile_sweep plain")),
            ("37c", True, "volumes.gridvolume_spectral.grid", S37_BANDS,
             ("grid_gather plain",))):
        phase_clock(tag)
        t0 = time.perf_counter()
        # max_depth 6 (12 until phase 39 was added): the time limit
        sc = load_dict(chromatic_atmosphere(64, 64, 2, spectral_sigma, 6),
                       spectral)
        assert tuple(sc.volumes[sigma_key.split(".")[1]]["grid"].shape[
            -1:]) == (C,)
        sigma_kind = (f"gridvolume_spectral C = {C}" if spectral_sigma
                      else "gridvolume")
        label = (f"chromatic 64^3 64x64 spp2 max_depth 6 (sigma_t "
                 f"{sigma_kind})")
        # 37c's adjoint lanes are phase 13b's C = S37_BANDS load B (the
        # plain legs launch no backward entry)
        with (capture_bwd(BWD_LOADS.setdefault("chromatic 37c", {}))
              if spectral_sigma else contextlib.nullcontext()):
            vr = grads_vs_plain(sc, lanes, [
                sigma_key, "volumes.gridvolume_srgb.grid"], legs)
        check_grid_launches(label, vr)
        vr["phase_s"] = time.perf_counter() - t0
        vr["channels"] = C
        rec["value_grads"][label] = vr
        fwd, bwd = vr["forward"], vr["backward"]
        print(f"# {tag} {label} value+grad through the kernels "
              f"{vr['value_grad_ms']:.1f} ms (forward "
              f"{vr['forward_ms']:.1f}, backward {vr['backward_ms']:.1f}); "
              f"grid_gather entries {vr['entries']} (fused = trilinear "
              f"lookups {fwd['lookups']} + {bwd['lookups']}, gather = srgb "
              f"lookups {fwd['srgb_lookups']} + {bwd['srgb_lookups']}), "
              f"grid_trilinear_bwd (C = {C}) "
              f"{bwd['launches']['grid_trilinear_bwd']} (= the adjoint's "
              f"trilinear lookups), tile_sweep {fwd['launches']['tile_sweep']}"
              f" + {bwd['launches']['tile_sweep']} (= queries); gradients "
              f"against the plain versions (rtol 1e-5, atol 1e-7) max abs "
              f"err {vr['grad_max_abs_err_vs_plain']}; |grad| sums "
              f"{vr['grad_abs_sums']}; {1 + len(legs)} legs "
              f"{vr['phase_s']:.1f} s", flush=True)

    # ---- 37d. volpathmis, moment and aov in spectral ----------------------
    phase_clock("37d")

    def moment_pool(label, child, seed, spp=n_load):
        sc = distant({"type": "moment", "child": child}, spp)
        film, secs, launches, counts = counted_pool(sc, lanes, seed=seed)
        r = rec["renders"][label] = check_atmosphere(
            f"{label} spp {spp} (seed {seed})", sc, film[..., :5], secs,
            launches, counts)
        w = float(film[..., 4].sum())
        r["y"] = float(film[..., 1].sum()) / w
        # the second moment of the splatted Y: a per-sample variance
        r["var_y"] = float(film[..., 6].sum()) / w - r["y"] ** 2
        assert r["var_y"] > 0, r
        return film, r

    film_m, rm = moment_pool("moment over volpath",
                             {"type": "volpath", "max_depth": 12,
                              "nee_transmittance": "residual"}, 1)
    rm["base_bit_equal_to_36a"] = bool(torch.equal(
        film_m[..., :5], REF_FILMS["spectral distant film"]))
    assert rm["base_bit_equal_to_36a"]
    # a quarter of the load (all of it until phase 39 was added): the time
    # limit; the z below weighs each side by its own sample count
    n_mis = n_load // 4
    film_v, rv = moment_pool("moment over volpathmis",
                             {"type": "volpathmis", "max_depth": 12}, 2,
                             n_mis)
    z, se = z_of(rv["y"], rm["y"], rv["var_y"], n_mis, rm["var_y"], n_load)
    rv["same_estimand_as_volpath"] = dict(y=rv["y"], volpath_y=rm["y"],
                                          z=z, std_err=se)
    assert abs(z) <= 3, rv["same_estimand_as_volpath"]
    print(f"# 37d volpathmis in spectral on bench.py's spectral load: "
          f"{rv['render_ms']:.1f} ms ({rv['host_syncs']} host syncs) "
          f"against volpath's {rm['render_ms']:.1f} ms ({rm['host_syncs']});"
          f" Y {rv['y']:.6f} against {rm['y']:.6f}: z = {z:.2f} (standard "
          f"error {se:.2e}; per-sample variances from moment's m2.y, "
          f"{rv['var_y']:.3e} and {rm['var_y']:.3e}); moment over volpath's "
          f"base film bit-equal to phase 36a's", flush=True)
    td = terrain_scene(V, F, 256, 256, 4, 6)
    td["integrator"] = {"type": "aov", "aovs": "dd:depth,nn:sh_normal",
                        "child": {"type": "volpath", "max_depth": 6}}
    tsc = load_dict(td, spectral)
    integrators.render(tsc, seed=0, spp=1, regen=True,
                       samples_per_pass=1 << 18)  # warm-up
    film_a, secs, launches, counts = counted_pool(tsc, 1 << 18)
    ra = rec["renders"]["aov over volpath terrain"] = check_pool(
        "aov (depth, sh_normal) over volpath, terrain(256) 256x256 spp4 "
        "max_depth 6, spectral (lane pool)", tsc, film_a[..., :5], secs,
        launches, counts, "tile_sweep", (1e-3, 5.0))
    w = film_a[..., 4:5].clamp(min=1e-12)
    depth = film_a[..., 5] / w[..., 0]
    normal = film_a[..., 6:9] / w
    ra["depth_hit_share"] = float((depth > 0).float().mean())
    assert bool(torch.isfinite(film_a).all()), "aov film not finite"
    # a depth where a camera ray hit the terrain: where the alpha is
    assert ra["depth_hit_share"] > 0.1, ra["depth_hit_share"]
    assert torch.equal(depth > 0, film_a[..., 3] > 0)
    # a pixel's mean of unit normals
    assert bool((normal.norm(dim=-1) <= 1.0 + 1e-4).all())
    print(f"# 37d aov over volpath in spectral, terrain(256): "
          f"{ra['render_ms']:.1f} ms, depth > 0 on "
          f"{ra['depth_hit_share']:.3f} of the pixels", flush=True)
    del film_m, film_v, film_a

    # ---- 37e. the measured terrain and emitter rays in spectral -------------
    phase_clock("37e")
    t0 = time.perf_counter()
    ply = os.path.join("smoke_out", "mesh_files", "terrain.ply")
    fields = synth_measured_fields(6, 16, 32, seed=5)
    # max_depth 2 (3 until phase 40 was added): the plain sweep's time
    msc = load_dict(measured_terrain(ply, fields, sky_image(128, 256, seed=6),
                                     64, 64, 4, 2), spectral)
    film_k, secs, launches, counts = counted_pool(msc, lanes, seed=3)
    rmt = rec["renders"]["measured terrain 64x64"] = check_pool(
        "measured terrain under an envmap 64x64 spp4 max_depth 2, spectral "
        "(lane pool)", msc, film_k, secs, launches, counts, "tile_sweep",
        (1e-3, 5.0))
    rmt["flips_vs_plain"] = films_vs_plain(msc, lanes, legs=("tile_sweep",))
    rmt["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = 1 << 16
    ed = {"type": "scene",
          "sensor": {"type": "perspective", "film": {"width": 4,
                                                     "height": 4}},
          "rect": {"type": "rectangle", "emitter": {
              "type": "area", "radiance": {"type": "uniform",
                                           "value": 0.5}}},
          "sun": {"type": "directional", "direction": [0.2, 0.1, -1.0],
                  "irradiance": {"type": "blackbody",
                                 "temperature": 5800.0}},
          "lamp": {"type": "point", "position": [0.0, 0.0, 1.0],
                   "intensity": [0.2, 0.5, 0.8]},
          "sky": {"type": "constant", "radiance": {"type": "d65"}}}
    esc = load_dict(ed, spectral)
    dev = esc.bsphere_center.device
    got = emitters.sample_emitter_ray(
        esc, rng.Sampler.seed(7, torch.arange(n, device=dev)),
        torch.zeros(n, device=dev))
    want = emitters.sample_emitter_ray(
        load_dict(ed, spectral, device="cpu"),
        rng.Sampler.seed(7, torch.arange(n)), torch.zeros(n))
    assert torch.equal(got[2].cpu(), want[2]), "emitter picks differ"
    assert len(torch.unique(want[2])) == 4
    # each emitter kind's largest differences (o, d absolute; wavelengths,
    # weights relative), all recorded before any is held to its tolerance
    kind_of = esc.emitter_kind[got[2]].cpu()
    errs = {}
    for k, kind in enumerate(esc.config.emitter_kinds):
        m = kind_of == k
        errs[kind] = {name: float(((a_.cpu()[m] - b_[m]).abs() / (
            1.0 if name in ("o", "d") else b_[m].abs().clamp(min=1e-6)))
            .max()) for name, a_, b_ in (
                ("o", got[0].o, want[0].o), ("d", got[0].d, want[0].d),
                ("wavelengths", got[0].wavelengths, want[0].wavelengths),
                ("weight", got[1], want[1]))}
    rec["emitter_rays_max_err"] = errs
    rec["emitter_rays_s"] = time.perf_counter() - t0
    print(f"# 37e sample_emitter_ray in spectral, card against CPU, the "
          f"largest difference by kind: {errs}", flush=True)
    for name, a_, b_, rtol, atol in (
            ("o", got[0].o, want[0].o, 1e-6, 1e-4),
            ("d", got[0].d, want[0].d, 1e-6, 1e-4),
            ("wavelengths", got[0].wavelengths, want[0].wavelengths, 1e-5,
             1e-5),
            ("weight", got[1], want[1], 1e-4, 1e-6)):
        torch.testing.assert_close(a_.cpu(), b_, rtol=rtol, atol=atol,
                                   msg=name)
    print(f"# 37e measured terrain in spectral 64x64 spp4 max_depth 3: "
          f"{rmt['render_ms']:.1f} ms ({rmt['phase_s']:.1f} s with the "
          f"load and the plain leg), tile_sweep launches "
          f"{launches['tile_sweep']} (= queries), kernel vs plain sweep "
          f"films {rmt['flips_vs_plain']} pixels over tolerance (budget 2); "
          f"sample_emitter_ray in spectral on 2^16 lanes against the CPU "
          f"({rec['emitter_rays_s']:.1f} s): picks equal, o and d within "
          f"1e-4, wavelengths 1e-5 and weights 1e-4 relative", flush=True)
    return rec


# ---- phase 38: the double-precision variants (slice 6d) ---------------------

# H100 SXM FP64 (non-tensor) peak: half the FP32 rate (NVIDIA data sheet)
FP64_FLOPS = FP32_FLOPS / 2
# phase 38f's batches: 8 scan renders of 4,096 samples (32,768 in all;
# 8,192 a batch until phase 39 was added: the time limit)
S38_BATCHES, S38_BATCH = 8, 1 << 12
# phase 38's device and 38a's loads: 2^20 terrain rays, 2^19 forest rays,
# 64^3 tables (a CPU rehearsal of the phase maps and shrinks them)
S38_DEVICE, S38_RAYS, S38_GRID = "cuda", 1 << 20, 64


def bound64(nbytes, ops):
    """bound() at the FP64 peak: (least ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def widened(tiles):
    """A tile set as a double variant's scene carries it: the floating
    arrays in float64, the root box and packed rows rebuilt from them."""
    from eradiate_kernel_tpu_torch.ops import intersect

    out = {k: v.double() if v.is_floating_point() else v
           for k, v in tiles.items() if k not in ("rows", "root")}
    out["root"], out["rows"] = intersect.sweep_tables(out)
    return out


def ray64(ray):
    """The ray in float64 (its float32 values widened)."""
    from eradiate_kernel_tpu_torch.core.ray import Ray

    return Ray.make(ray.o.double(), ray.d.double(), mint=ray.mint.double(),
                    maxt=ray.maxt.double())


def f64_mesh_load(name, run, plain, args, args32, bound_of):
    """One float64 mesh entry against its float64 plain version on one
    load (every output bit for bit, one launch of the _f64 entry), its
    time beside the float32 entry's on the same rays, device times, the
    bound at the FP64 rate. Returns the load's record."""
    from eradiate_kernel_tpu_torch.ops import intersect

    before = dict(intersect.launches)
    out = run(*args)
    torch.cuda.synchronize()
    assert intersect.launches[name + "_f64"] == before[name + "_f64"] + 1
    assert intersect.launches[name] == before[name]
    ref, plain_ms = cuda_once(lambda: plain(*args))
    for what, a, b in zip(("t", "uv", "prim", "shape", "visits/stats"), out,
                          ref):
        assert torch.equal(a, b), f"{name} f64: {what} differs from plain"
    assert out[0].dtype == torch.float64
    funcs = KERNEL_FUNCS[name]
    bound_ms, bound_by = bound_of(out)
    return dict(
        ms=cuda_ms(lambda: run(*args), reps=10),
        f32_ms=cuda_ms(lambda: run(*args32), reps=10), plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
        hit_frac=float(torch.isfinite(out[0]).float().mean()),
        device_us={"f64": device_us(lambda: run(*args), funcs, reps=20),
                   "f32": device_us(lambda: run(*args32), funcs, reps=20)})


def f64_kernel_loads(V, F, lanes):
    """Phase 38a: each float64 entry against its float64 plain version on
    the float32 rows' loads: the sweep on terrain(256) under 2^20 primary
    and incoherent rays, the fused query on the rgb_double flagship's cube
    (32,768 rays), both BVH walks on the forest (2^19 rays), and
    grid_gather's gather, trilinear and backward entries on a 64^3 table
    at C = 1, 3, 8 (beside index_select, grid_sample and grid_sample's
    backward in float64). Returns {load: record}."""
    from eradiate_kernel_tpu_torch.core.ray import Ray
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.ops import gather, intersect
    from eradiate_kernel_tpu_torch.ops.accel import pack_tiles
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.textures import volumes
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    dev = torch.device(S38_DEVICE)
    f64 = torch.float64
    rec = {}
    t32 = {k: torch.as_tensor(v, device=dev) for k, v in
           pack_tiles(V, None, F, np.zeros(len(F), np.int32)).items()}
    t32["root"], t32["rows"] = intersect.sweep_tables(t32)
    t64 = widened(t32)
    T = t64["lo"].shape[0]
    for kind in ("primary", "incoherent"):
        o, d = make_rays(S38_RAYS, kind)
        r32 = Ray.make(torch.as_tensor(o, device=dev),
                       torch.as_tensor(d, device=dev))
        a64 = intersect.prepare_sweep(t64, ray64(r32))[0]
        a32 = intersect.prepare_sweep(t32, r32)[0]

        def sweep_bound64(out, a=a64):
            n_pad, nb = a[0].shape[0], a[2].shape[0]
            visits = int(out[4].sum())
            nbytes = (n_pad * 64 + visits * 12 + nb * 4
                      + T * intersect.TILE_K * 11 * 8
                      + n_pad * (8 + 16 + 4 + 4) + nb * 4)
            return bound64(nbytes, visits * intersect.RAY_BLOCK
                           * intersect.TILE_K * intersect.FLOPS_PER_TEST)

        rec[f"tile_sweep terrain {kind}"] = f64_mesh_load(
            "tile_sweep", intersect._sweep_cuda, intersect._sweep_plain, a64,
            a32, sweep_bound64)
    flag = load_dict(atmosphere(256, 256, 4, 12, grid_res=64),
                     Variant("rgb_double"))
    flag32 = load_dict(atmosphere(256, 256, 4, 12, grid_res=64))
    gen = torch.Generator().manual_seed(38)
    o = torch.rand(lanes, 3, generator=gen) * torch.tensor([30.0, 30.0, 1.0])
    o = (o - torch.tensor([15.0, 15.0, 0.0])).to(dev)
    d = torch.nn.functional.normalize(torch.randn(lanes, 3, generator=gen),
                                      dim=-1).to(dev)
    cube32 = Ray.make(o, d)
    a64 = intersect.prepare_small(flag.geo.tiles(), ray64(cube32))
    a32 = intersect.prepare_small(flag32.geo.tiles(), cube32)

    def fused_bound64(out):
        n, Tc = lanes, a64[5].shape[0]
        nbytes = (n * 64 + 48 + Tc * 48 + Tc * intersect.TILE_K * 11 * 8
                  + n * 32 + out[4].shape[0] * 4)
        return bound64(nbytes, int(out[4].sum()) * intersect.RAY_BLOCK
                       * intersect.TILE_K * intersect.FLOPS_PER_TEST)

    rec["tile_sweep fused cube"] = f64_mesh_load(
        "tile_sweep", intersect._sweep_small_cuda,
        intersect._sweep_small_plain, a64, a32, fused_bound64)
    forest32 = load_dict(forest_scene(8, 8, 1, 6)).geo.tiles()
    forest64 = load_dict(forest_scene(8, 8, 1, 6),
                         Variant("rgb_double")).geo.tiles()
    o, d = make_rays(S38_RAYS // 2, "primary")
    o = o * np.float32([8, 8, 1])
    fr32 = Ray.make(torch.as_tensor(o, device=dev),
                    torch.as_tensor(d, device=dev))
    for name in ("tile_bvh", "tile_bvh8"):
        wide = name == "tile_bvh8"
        a64 = intersect.prepare_bvh(forest64, ray64(fr32), wide=wide)[0]
        a32 = intersect.prepare_bvh(forest32, fr32, wide=wide)[0]

        def bvh_bound64(out, a=a64, wide=wide):
            g = intersect.BVH_GROUP
            inner, leaves = (int(x) for x in out[4][:, :2].sum(0))
            tree = sum(x.numel() * x.element_size() for x in a[1:5])
            nbytes = (a[0].shape[0] * (64 + 36) + out[4].numel() * 4 + tree
                      + a[5].numel() * 8)
            ops = (leaves * g * intersect.TILE_K * intersect.FLOPS_PER_TEST
                   + inner * g * (8 if wide else 2)
                   * intersect.FLOPS_PER_SLAB)
            return bound64(nbytes, ops)

        rec[f"{name} forest"] = f64_mesh_load(
            name, lambda *a, n=name: intersect._traverse_cuda(n, *a),
            intersect._PLAIN_WALKS[name], a64, a32, bvh_bound64)
    # grid_gather at C = 1, 3, 8 on a 64^3 table, 32,768 random lanes
    gen = torch.Generator().manual_seed(380)
    L = lanes
    for C in (1, 3, S37_BANDS):
        n = S38_GRID
        grid = torch.rand(1, n, n, n, C, generator=gen, dtype=f64).to(dev)
        packed = volumes.packed_corners(grid)
        pl = torch.rand(L, 3, generator=gen, dtype=f64).to(dev)
        slot = torch.zeros(L, dtype=torch.int32, device=dev)
        ct = torch.randn(L, C, generator=gen, dtype=f64).to(dev)
        grid32, packed32 = grid.float(), packed.float()
        pl32, ct32 = pl.float(), ct.float()
        shape = tuple(grid.shape)
        idx = volumes._corner0(shape[:4], slot, pl)[0]
        before = dict(gather.launches)
        rows = gather._gather_cuda(packed, idx)
        look = gather.grid_trilinear(packed, shape, slot, pl)
        bwd = gather.grid_trilinear_bwd(ct, shape, slot, pl)
        torch.cuda.synchronize()
        assert (gather.launches["grid_gather_f64"]
                == before["grid_gather_f64"] + 2)
        assert (gather.launches["grid_trilinear_bwd_f64"]
                == before["grid_trilinear_bwd_f64"] + 1)
        assert gather.launches["grid_gather"] == before["grid_gather"]
        assert torch.equal(rows, gather.gather_rows_plain(packed, idx))
        assert torch.equal(look, volumes.trilinear_gather_plain(
            packed, shape, slot, pl))
        bwd_ref = volumes.trilinear_backward_plain(ct, shape, slot, pl)
        # the atomics add in an order that changes from run to run
        torch.testing.assert_close(bwd, bwd_ref, rtol=1e-12, atol=1e-15)
        # exact where no two lanes share a corner
        pl_d = distinct_corner_lanes(n, dev, gen).double()
        ct_d = torch.randn(pl_d.shape[0], C, generator=gen,
                           dtype=f64).to(dev)
        slot_d = torch.zeros(pl_d.shape[0], dtype=torch.int32, device=dev)
        assert torch.equal(
            gather.grid_trilinear_bwd(ct_d, shape, slot_d, pl_d),
            volumes.trilinear_backward_plain(ct_d, shape, slot_d, pl_d))
        vol = grid.permute(0, 4, 1, 2, 3).contiguous()
        g = (pl * 2 - 1).view(1, 1, 1, L, 3)
        lib = lambda: torch.nn.functional.grid_sample(
            vol, g, mode="bilinear", padding_mode="border",
            align_corners=True)
        lib_err = float((lib().reshape(C, L).T - look).abs().max())
        assert lib_err < 1e-12, lib_err
        volg = vol.clone().requires_grad_()
        with torch.enable_grad():
            sampled = torch.nn.functional.grid_sample(
                volg, g, mode="bilinear", padding_mode="border",
                align_corners=True)
        ct_lib = ct.T.reshape(1, C, 1, 1, L).contiguous()
        lib_bwd = lambda: torch.autograd.grad(sampled, volg, ct_lib,
                                              retain_graph=True)[0]
        lib_bwd_err = float((lib_bwd().permute(0, 2, 3, 4, 1) - bwd)
                            .abs().max())
        assert lib_bwd_err < 1e-10, lib_bwd_err
        R = packed.shape[1]
        run = {
            "gather": (lambda: gather._gather_cuda(packed, idx),
                       lambda: gather._gather_cuda(packed32, idx),
                       lambda: gather.gather_rows_plain(packed, idx),
                       lambda: torch.index_select(packed, 0, idx),
                       L * (4 + 2 * R * 8), 0, ("grid_gather_kernel",), 0.0),
            "trilinear": (lambda: gather.grid_trilinear(packed, shape, slot,
                                                        pl),
                          lambda: gather.grid_trilinear(packed32, shape, slot,
                                                        pl32),
                          lambda: volumes.trilinear_gather_plain(
                              packed, shape, slot, pl), lib,
                          L * (24 + 4 + 8 * C * 8 + C * 8), L * (12 + 21 * C),
                          ("grid_trilinear_kernel",), 0.0),
            "backward": (lambda: gather.grid_trilinear_bwd(ct, shape, slot,
                                                           pl),
                         lambda: gather.grid_trilinear_bwd(ct32, shape, slot,
                                                           pl32),
                         lambda: volumes.trilinear_backward_plain(
                             ct, shape, slot, pl), lib_bwd,
                         trilinear_bwd_bytes(shape, slot, pl, 8),
                         L * (12 + 14 * C), ("grid_trilinear_bwd",),
                         float((bwd - bwd_ref).abs().max()))}
        for entry, (k64, k32, plain, library, nbytes, ops, funcs,
                    err) in run.items():
            if entry == "gather" and C != 1:
                continue  # the gather entry's rows: the packed C = 1 table
            bound_ms, bound_by = bound64(nbytes, ops)
            rec[f"grid_gather {entry} {n}^3 C={C}"] = dict(
                ms=cuda_ms(k64, reps=50), f32_ms=cuda_ms(k32, reps=50),
                plain_ms=cuda_ms(plain, reps=20),
                library_ms=cuda_ms(library, reps=20), bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, lanes=L, channels=C,
                device_us={"f64": device_us(k64, funcs),
                           "f32": device_us(k32, funcs),
                           "library": device_us(library)},
                library_max_abs_err=(lib_err if entry == "trilinear"
                                     else lib_bwd_err if entry == "backward"
                                     else 0.0))
    for load, r in rec.items():
        print(f"# 38a {load} (float64): kernel {r['ms']:.4f} ms (float32 "
              f"entry {r['f32_ms']:.4f} ms), plain {r['plain_ms']:.3f} ms "
              f"(max abs err {r['max_abs_err']:.1e}), "
              + (f"library {r['library_ms']:.4f} ms, "
                 if "library_ms" in r else "")
              + f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, FP64); "
              f"device us a call {r['device_us']}", flush=True)
    return rec


def far_hits(gate):
    """Phase 38b: a unit sphere (analytic) and the 12-triangle cube mesh
    hit from 1e5 away through the user's entry point (ray_intersect) on the
    card, the cube through the fused sweep, tile_bvh and tile_bvh8
    (ERT_ACCEL): in rgb_double within 1e-6 of the distance and 100x closer
    than rgb, one launch of the _f64 entry each. Returns {case: errors}."""
    from eradiate_kernel_tpu_torch.core.ray import Ray
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.ops import intersect
    from eradiate_kernel_tpu_torch.render.geometry import ray_intersect
    from eradiate_kernel_tpu_torch.scene import load_dict

    far = 1e5 + 0.3  # a fraction float32 cannot hold
    out = {}
    for shape, accel, kernel in (("sphere", "analytic", None),
                                 ("cube", "tiles", "tile_sweep"),
                                 ("cube", "bvh", "tile_bvh"),
                                 ("cube", "bvh8", "tile_bvh8")):
        s = ({"type": "sphere", "radius": 1.0} if shape == "sphere"
             else {"type": "cube"})
        d = {"type": "scene", "s": s, "sensor": {
            "type": "perspective", "film": {"width": 2, "height": 2}}}
        errs = {}
        with env(ERT_ACCEL="auto" if accel == "analytic" else accel):
            for mode, dt in (("rgb", torch.float32),
                             ("rgb_double", torch.float64)):
                scene = load_dict(d, Variant(mode))
                o = torch.tensor([[0.0, 0.0, far], [0.25, -0.125, far]],
                                 dtype=torch.float64).to(dt)
                ray = Ray.make(o.to(S38_DEVICE), torch.tensor(
                    [[0.0, 0.0, -1.0]] * 2, dtype=dt, device=S38_DEVICE))
                before = dict(intersect.launches)
                t = ray_intersect(scene.geo, ray).t
                torch.cuda.synchronize()
                if kernel is not None:
                    key = kernel + ("_f64" if dt == torch.float64 else "")
                    assert intersect.launches[key] == before[key] + 1, key
                rows = 1 if shape == "sphere" else 2
                errs[mode] = float((t[:rows].double() - (far - 1.0)).abs()
                                   .max())
        assert errs["rgb_double"] < gate, (shape, accel, errs)
        assert errs["rgb_double"] < 1e-2 * errs["rgb"], (shape, accel, errs)
        out[f"{shape} {accel}"] = errs
    print(f"# 38b hits from 1e5 away, |t - (1e5 + 0.3 - 1)|: {out}",
          flush=True)
    return out


def counted_scan(scene, seed=0, spp=None, samples_per_pass=None):
    """integrators.render(scene) on the scan driver under counting():
    (film, seconds, counts with the launches)."""
    from eradiate_kernel_tpu_torch import integrators

    with counting() as read:
        t0 = time.perf_counter()
        film = integrators.render(scene, seed=seed, spp=spp,
                                  samples_per_pass=samples_per_pass,
                                  develop_film=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read()
    return film, seconds, got


def pixel_z(a, b):
    """(z, standard error) of the mean over pixels of a - b, two films of
    independent seeds: each pixel's difference has mean 0 under one
    estimand, so its spread over the pixels gives the standard error."""
    d = (a - b).reshape(-1).double()
    se = float(d.std() / np.sqrt(d.numel()))
    return float(d.mean()) / se, se


def emitter_ray_gaps(variant, n=1 << 14):
    """sample_emitter_ray on the card against the CPU in ``variant``
    (phase 37e's scene): each emitter kind's largest difference of o, d
    (absolute), wavelengths and weights (relative), and its worst lane's
    index, direction and first six sampler draws."""
    from eradiate_kernel_tpu_torch import emitters
    from eradiate_kernel_tpu_torch.core import rng
    from eradiate_kernel_tpu_torch.scene import load_dict

    ed = {"type": "scene",
          "sensor": {"type": "perspective", "film": {"width": 4,
                                                     "height": 4}},
          "rect": {"type": "rectangle", "emitter": {
              "type": "area", "radiance": {"type": "uniform",
                                           "value": 0.5}}},
          "sun": {"type": "directional", "direction": [0.2, 0.1, -1.0],
                  "irradiance": {"type": "blackbody",
                                 "temperature": 5800.0}},
          "lamp": {"type": "point", "position": [0.0, 0.0, 1.0],
                   "intensity": [0.2, 0.5, 0.8]},
          "sky": {"type": "constant", "radiance": {"type": "d65"}}}
    esc = load_dict(ed, variant)
    cpu = load_dict(ed, variant, device="cpu")
    dt = esc.config.variant.dtype
    got = emitters.sample_emitter_ray(
        esc, rng.Sampler.seed(7, torch.arange(n, device=S38_DEVICE)),
        torch.zeros(n, dtype=dt, device=S38_DEVICE))
    want = emitters.sample_emitter_ray(cpu, rng.Sampler.seed(
        7, torch.arange(n)), torch.zeros(n, dtype=dt))
    assert torch.equal(got[2].cpu(), want[2]), "emitter picks differ"
    kind_of = esc.emitter_kind[got[2]].cpu()
    out = {}
    for k, kind in enumerate(esc.config.emitter_kinds):
        m = kind_of == k
        rec = {}
        for name, a_, b_ in (("o", got[0].o, want[0].o),
                             ("d", got[0].d, want[0].d),
                             ("wavelengths", got[0].wavelengths,
                              want[0].wavelengths),
                             ("weight", got[1], want[1])):
            e = ((a_.cpu() - b_).abs() / (1.0 if name in ("o", "d")
                                          else b_.abs().clamp(min=1e-6)))
            e = e.reshape(n, -1).max(1).values.double()
            e = torch.where(m, e, torch.zeros_like(e))
            rec[name] = float(e.max())
            if name == "d":
                lane = int(e.argmax())
                s = rng.Sampler.seed(7, torch.tensor([lane]))
                draws = []
                for _ in range(6):
                    s, u = s.next_1d()
                    draws.append(float(u))
                rec["worst_d_lane"] = dict(
                    lane=lane, draws=draws,
                    d_card=got[0].d[lane].cpu().tolist(),
                    d_cpu=want[0].d[lane].tolist())
        out[kind] = rec
    return out


def slice_6d_phases(V, F, lanes):
    """Phase 38 (slice 6d): the double-precision variants on the card.
    (a) f64_kernel_loads; (b) far_hits; (c) the flagship atmosphere(256,
    256, 4, 12, grid_res=64) in rgb_double on the scan driver (the
    reference's one driver in double; spp 4, bench.py's 64 cut for the time
    limit): tile_sweep_f64 launches == queries, time and host syncs beside
    rgb's at the same spp (another seed); the films the same estimand (z
    of the pixels' Y differences within 3) with the ground lowered by 1e-3
    (128x128), the as-built z recorded (its coplanar tie resolves by the
    last ulp, differently in float32 and float64); (d) large3d (64^3) value+grad with
    respect to the grid in rgb_double at 64x64 spp 2 through
    autodiff.render(regen=False): fused and backward _f64 launches == the
    lookups, the film equal to the primal's bit for bit, the gradient
    within rtol 1e-9, atol 1e-15 of the plain versions' on the card; (e)
    terrain(256) in rgb_double 256x256 spp 2 on the scan driver: at most 2
    pixels off the float64 plain sweep, and the forest (128x128 spp 4)
    through each BVH kernel's float64 entry, launches == queries; (f)
    spectral_double on bench.py's
    spectral load (1x1 distant) at 32,768 samples (8 scan batches) within 3
    standard errors of spectral, and render(regen=True) of a double scene
    raising on the card; (g) phase 37e's emitter rays in spectral_double
    against the CPU (ROADMAP Queue 3's open question). Returns the
    records."""
    from eradiate_kernel_tpu_torch import films, integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.ops import gather, intersect
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils import autodiff
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    rec = {}
    phase_clock("38a")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec["kernels"] = f64_kernel_loads(V, F, lanes)
    rec["kernels_s"] = time.perf_counter() - t0

    phase_clock("38b")
    rec["far_hits"] = far_hits(1e-6)

    # ---- 38c. the flagship in rgb_double on the scan driver -----------------
    phase_clock("38c")

    def flagship(variant, width=256, lowered=False):
        d = atmosphere(width, width, 4, 12, grid_res=64)
        d["integrator"]["nee_transmittance"] = "residual"
        if lowered:  # the coplanar tie removed (ROADMAP Queue 3)
            d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
        return load_dict(d, Variant(variant))

    def y_image(film):
        return film[..., 1] / film[..., 4]

    runs, ys = {}, {}
    for case, width, lowered in (("as built", 256, False),
                                 ("ground lowered", 128, True)):
        for seed, variant in enumerate(("rgb", "rgb_double")):
            scene = flagship(variant, width, lowered)
            if not lowered:
                integrators.render(scene, seed=0, spp=1)  # warm-up
            film, secs, got = counted_scan(scene, seed=seed)
            la = got["launches"]
            sweep = "tile_sweep" + ("_f64" if scene.config.variant.is_double
                                    else "")
            assert la[sweep] == got["queries"] > 0, (variant, got)
            assert sum(la.values()) == la[sweep], (variant, la)
            img = films.develop(film)
            assert bool(torch.isfinite(img).all())
            assert img.dtype == scene.config.variant.dtype
            runs[f"{variant} {case}"] = dict(
                render_ms=secs * 1e3, queries=got["queries"],
                launches=la[sweep], host_syncs=got["host_syncs"],
                image_mean=float(img.mean()), width=width, seed=seed)
            ys[(variant, case)] = y_image(film).double()
    z = {}
    for case in ("as built", "ground lowered"):
        zc, se = pixel_z(ys[("rgb_double", case)], ys[("rgb", case)])
        z[case] = dict(z=zc, std_err=se)
    rec["flagship"] = dict(runs, z=z)
    # as built, the ground is coplanar with the cube's floor and the last
    # ulp of either hit decides between them: float32 and float64 resolve
    # that tie differently (recorded), so the estimand is held to 3
    # standard errors with the ground lowered by 1e-3, as the CPU tests do
    assert abs(z["ground lowered"]["z"]) <= 3, rec["flagship"]
    r64, r32 = runs["rgb_double as built"], runs["rgb as built"]
    print(f"# 38c flagship 256x256 spp4 max_depth 12 on the scan driver: "
          f"rgb_double {r64['render_ms']:.1f} ms (queries {r64['queries']} ="
          f" tile_sweep_f64 launches, host syncs {r64['host_syncs']}) "
          f"against rgb {r32['render_ms']:.1f} ms (host syncs "
          f"{r32['host_syncs']}); image means {r64['image_mean']:.6f} / "
          f"{r32['image_mean']:.6f}, z over the pixels' Y {z['as built']}; "
          f"with the ground lowered (128x128): z {z['ground lowered']}",
          flush=True)

    # ---- 38d. large3d value+grad in rgb_double through the scan driver ------
    phase_clock("38d")
    d = atmosphere(64, 64, 2, 12, grid_res=(64, 64, 64))
    d["integrator"]["nee_transmittance"] = "residual"
    large = load_dict(d, Variant("rgb_double"))
    key = "volumes.gridvolume.grid"
    primal = integrators.render(large, seed=0, develop_film=False)
    grads, vg = {}, {}
    for leg, ctx in (("kernels", contextlib.nullcontext),
                     ("plain", gather.use_plain)):
        pm = autodiff.traverse(large).keep([key])
        params = pm.trainable()
        with ctx(), counting() as read:
            t0 = time.perf_counter()
            film = integrators.render(pm.with_trainable(params), seed=0,
                                      develop_film=False)
            loss = films.develop(film).mean()
            torch.cuda.synchronize()
            fwd = read()
            loss.backward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            end = read()
        assert torch.equal(film.detach(), primal), f"38d {leg}: film"
        grads[leg] = params[key].grad
        vg[leg] = dict(value_grad_ms=secs * 1e3, lookups=fwd["lookups"],
                       forward=fwd["launches"], total=end["launches"],
                       host_syncs=end["host_syncs"])
    k = vg["kernels"]
    assert k["forward"]["grid_gather_f64"] == k["lookups"] > 0, k
    bwd_launches = (k["total"]["grid_trilinear_bwd_f64"]
                    - k["forward"]["grid_trilinear_bwd_f64"])
    assert bwd_launches == k["lookups"], k
    assert k["total"]["grid_gather"] == k["total"]["grid_trilinear_bwd"] == 0
    g, gp = grads["kernels"], grads["plain"]
    assert g.dtype == torch.float64 and bool(g.abs().sum() > 0)
    torch.testing.assert_close(g, gp, rtol=1e-9, atol=1e-15)
    rec["large3d_value_grad"] = dict(
        vg, backward_launches=bwd_launches,
        grad_max_abs_err_vs_plain=float((g - gp).abs().max()),
        grad_abs_sum=float(g.abs().sum()))
    print(f"# 38d large3d 64x64 spp2 value+grad in rgb_double (scan driver):"
          f" {k['value_grad_ms']:.1f} ms, lookups {k['lookups']} = fused "
          f"f64 launches = backward f64 launches {bwd_launches}, film equal "
          f"to the primal's, gradient within "
          f"{rec['large3d_value_grad']['grad_max_abs_err_vs_plain']:.1e} of "
          f"the plain versions' ({vg['plain']['value_grad_ms']:.1f} ms)",
          flush=True)

    # ---- 38e. terrain(256) in rgb_double against the plain sweep ------------
    phase_clock("38e")
    # spp 2 and max_depth 3 (4 and 6 until phase 39 was added): the time
    # limit, most of it the plain sweep's
    terr = load_dict(terrain_scene(V, F, 256, 256, 2, 3),
                     Variant("rgb_double"))
    film_k, secs, got = counted_scan(terr, seed=3)
    assert got["launches"]["tile_sweep_f64"] == got["queries"] > 0, got
    with intersect.use_plain():
        film_p = integrators.render(terr, seed=3, develop_film=False)
    flips = films_equivalent(film_p.cpu().numpy(), film_k.cpu().numpy(),
                             max_flips=2)
    rec["terrain"] = dict(render_ms=secs * 1e3, queries=got["queries"],
                          pixels_over_tolerance=flips,
                          bit_equal=bool(torch.equal(film_k, film_p)))
    print(f"# 38e terrain(256) 256x256 spp2 max_depth 3 in rgb_double: "
          f"{secs * 1e3:.1f} ms, tile_sweep_f64 launches "
          f"{got['launches']['tile_sweep_f64']} = queries, kernel vs plain "
          f"sweep {flips} pixels over tolerance (budget 2), bit-equal "
          f"{rec['terrain']['bit_equal']}", flush=True)
    # the forest in rgb_double through each BVH kernel's float64 entry
    forest = load_dict(forest_scene(128, 128, 4, 6), Variant("rgb_double"))
    rec["forest"] = {}
    for name, wide in (("tile_bvh", "0"), ("tile_bvh8", "1")):
        with env(ERT_BVH_WIDE=wide):
            film, secs, got = counted_scan(forest)
        la = got["launches"]
        assert la[name + "_f64"] == got["queries"] > 0, (name, got)
        assert sum(la.values()) == la[name + "_f64"], (name, la)
        assert bool(torch.isfinite(film).all())
        rec["forest"][name] = dict(render_ms=secs * 1e3,
                                   queries=got["queries"],
                                   launches=la[name + "_f64"])
    print(f"# 38e forest 128x128 spp4 max_depth 6 in rgb_double (scan): "
          f"{rec['forest']}", flush=True)

    # ---- 38f. spectral_double on bench.py's spectral load --------------------
    phase_clock("38f")

    def distant(variant):
        # max_depth 3 (bench.py: 12; 6 until phase 42 was added, 12 until
        # phase 39 was): the time limit
        d = atmosphere(spp=S38_BATCH, max_depth=3, grid_res=64,
                       sensor="distant")
        d["integrator"]["nee_transmittance"] = "residual"
        # the sensor targets the coplanar tie (0.5, 0.5, 0): lowered as in
        # 38c, float32 and float64 resolving it differently
        d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
        return load_dict(d, Variant(variant))

    ys, secs = {}, {}
    for seed0, variant in ((200, "spectral"), (100, "spectral_double")):
        scene = distant(variant)
        vals = []
        t0 = time.perf_counter()
        for b in range(S38_BATCHES):
            film = integrators.render(scene, seed=seed0 + b,
                                      develop_film=False)
            vals.append(y_of(film))
        torch.cuda.synchronize()
        secs[variant] = time.perf_counter() - t0
        ys[variant] = torch.tensor(vals, dtype=torch.float64)
        if variant == "spectral_double":
            assert film.dtype == torch.float64
            try:
                integrators.render(scene, regen=True, samples_per_pass=lanes)
                raise AssertionError("render(regen=True) ran in double")
            except NotImplementedError as e:
                assert "reference's fails in double precision" in str(e)
    y64, y32 = ys["spectral_double"], ys["spectral"]
    # the batch means' spread: var(batch) / n of each variant's mean
    z, se = z_of(float(y64.mean()), float(y32.mean()), float(y64.var()),
                 S38_BATCHES, float(y32.var()), S38_BATCHES)
    rec["spectral"] = dict(
        y=float(y64.mean()), y_spectral=float(y32.mean()), z=z, std_err=se,
        ms=secs["spectral_double"] * 1e3, spectral_ms=secs["spectral"] * 1e3,
        samples=S38_BATCHES * S38_BATCH)
    assert abs(z) <= 3, rec["spectral"]
    print(f"# 38f bench.py's spectral load at {S38_BATCHES} x {S38_BATCH} "
          f"samples on the scan driver: spectral_double Y "
          f"{rec['spectral']['y']:.6f} ({secs['spectral_double']:.1f} s) "
          f"against spectral {rec['spectral']['y_spectral']:.6f} "
          f"({secs['spectral']:.1f} s): z {z:.2f} (standard error "
          f"{se:.2e}, from the batches' spread); render(regen=True) raises",
          flush=True)

    # ---- 38g. phase 37e's emitter rays in spectral_double ------------------
    phase_clock("38g")
    rec["emitter_rays"] = {v: emitter_ray_gaps(Variant(v))
                           for v in ("spectral", "spectral_double")}
    print(f"# 38g sample_emitter_ray card against CPU, the largest "
          f"differences by kind and the worst direction's lane: "
          f"{rec['emitter_rays']}", flush=True)
    return rec


# ---- phase 39: the polarized variant (slice 6e) ------------------------------

# bench.py's polarized lane pool (its BENCH_LANES default for the load)
S39_LANES = 4096


def polarized_atmosphere(width, spp, grid_res=64, phase=None,
                         integrator="stokes"):
    """bench.py's polarized load: atmosphere(width, width, spp, 8,
    grid_res) under stokes(volpath, max_depth 8) with residual NEE, in
    Variant("rgb", polarized=True); ``phase`` replaces the Rayleigh phase,
    ``integrator="volpath"`` drops the stokes wrapper."""
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(width, width, spp, 8, grid_res=grid_res)
    child = {"type": "volpath", "max_depth": 8,
             "nee_transmittance": "residual"}
    d["integrator"] = (child if integrator == "volpath" else
                       {"type": "stokes", "child": child})
    if phase is not None:
        d["atmo"]["interior"]["phase"] = phase
    return load_dict(d, Variant("rgb", polarized=True))


def stokes_samples(scene, seed):
    """The scan driver's samples of a stokes scene: stokes.sample_aov over
    one wavefront of every sample, as render_wavefront runs it -> (N, 4)
    rows [Y (with the ray weight), S1, S2, S3], sample s in pixel s // spp
    (render_wavefront splats them)."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.integrators import common, stokes

    cfg = scene.config
    total = cfg.film_height * cfg.film_width * cfg.spp
    smp, ray, rw, _pos = integrators._camera_lanes(
        scene, seed, cfg.spp, torch.arange(
            total, dtype=torch.int64, device=scene.bsphere_center.device))
    spec, _valid, _smp, aovs = stokes.sample_aov(scene, smp, ray, rw)
    y = common.spec_to_xyz(spec * rw, ray.wavelengths)[:, 1:2]
    return torch.cat([y, aovs], -1)


def pool_vs_scan(film, rows, spp):
    """Each pixel's mean of Y and S1..S3 on the lane pool (``film``)
    against the scan driver's (``rows``, the same samples; a sample
    differs where an ulp between the two drivers' arithmetic flips one of
    its decisions). Returns: the pixel-quantities that differ at all; those
    beyond 3 standard errors of the pixel mean (the samples' spread in the
    pixel over sqrt(spp); plus 1e-6 of the value where the spread is 0),
    the largest such z, and the chance rate's budget for them (a 3-sigma
    gate passes 0.27 % of independent estimates' pixels); and, per
    quantity, the z of the mean over pixels of the difference (phase
    38c's pixel_z)."""
    pool = torch.stack([film[..., 1], film[..., 5], film[..., 6],
                        film[..., 7]], -1) / film[..., 4:5]
    pool = pool.reshape(-1, 4).double()
    per_pixel = rows.double().reshape(-1, spp, 4)
    mean = per_pixel.mean(1)
    se = per_pixel.std(1) / np.sqrt(spp)
    diff = pool - mean
    tol = 1e-6 * torch.clamp(mean.abs(), min=1.0)
    over = diff.abs() > 3 * se + tol
    z = torch.where(se > 0, diff.abs() / se,
                    torch.where(diff.abs() > tol, np.inf, 0.0))
    mean_z = {}
    # the differences beyond the films' float32 rounding (the pool sums a
    # pixel's samples in float32, here their mean is taken in float64)
    moved = torch.where(diff.abs() > tol, diff, 0.0)
    for i, name in enumerate(("Y", "S1", "S2", "S3")):
        d = moved[:, i]
        sd = float(d.std())
        mean_z[name] = float(d.mean()) / (sd / np.sqrt(d.numel())) \
            if sd > 0 else 0.0
    return dict(differing=int((diff.abs() > tol).sum()),
                compared=int(diff.numel()), over_3se=int(over.sum()),
                budget=int(0.0027 * over.numel()), z_max=float(z.max()),
                mean_z=mean_z)


def slice_6e_phases(V, F):
    """Phase 39 (slice 6e): the polarized variant on the card. (a)
    bench.py's polarized load at full size (64x64 spp 16, stokes(volpath)
    max_depth 8, residual NEE) on bench.py's lane pool of 4,096 lanes, and
    once more on 32,768 (time only): fused tile_sweep launches == queries,
    S3 exactly 0 everywhere (Rayleigh over a depolarizing ground), some
    |S1| + |S2| above 1e-4, and each pixel's Y and S1..S3 within 3
    standard errors of the scan driver's same samples but for the chance
    rate of a 3-sigma gate (0.27 % of them; pool_vs_scan), each mean
    difference over the pixels within 3 of its standard error; (b) the
    scene with an isotropic phase (64x64 spp 4): polarized_vol's S0
    against volpath's sample for sample (rtol 1e-5; at most 0.1 % of the
    samples may take another path where an ulp of the Mueller products'
    association flips a roulette), S1..S3 exactly 0; (c) the 64^3 grid under stokes(volpath)
    at 64x64 spp 2 on the pool: grid_gather launches == fused lookups;
    (d) terrain(256) with pplastic for its RPV under stokes(path) at
    256x256 spp 2 max_depth 3 on the scan driver (phase 40b holds the
    scene's film and gradients to the plain sweep's),
    tile_sweep launches == queries (the sorted pipeline: 1,017 tiles);
    (e) the optical bench of tests/test_polarization.py on the card (1x1
    radiancemeter, rectangles, no kernel): Malus's law at 0, 30, 60 and
    90 degrees, crossed polarizers, and a half-wave plate at 45 degrees
    between them. Returns the records."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.integrators import polarized_vol, volpath
    from eradiate_kernel_tpu_torch.scene import load_dict

    rec = {}
    # ---- 39a. bench.py's polarized load ------------------------------------
    phase_clock("39a")
    scene = polarized_atmosphere(64, 16)
    assert scene.config.variant.polarized
    assert integrators.regen_supported(scene.config)
    integrators.render(scene, seed=0, spp=1, regen=True,
                       samples_per_pass=S39_LANES)  # warm-up
    runs = {}
    for lanes in (S39_LANES, 8 * S39_LANES):
        film, secs, launches, counts = counted_pool(scene, lanes)
        runs[lanes] = check_atmosphere(
            f"polarized atmosphere 64x64 spp16 max_depth 8 stokes(volpath) "
            f"({lanes} lanes)", scene, film[..., :5], secs, launches, counts)
        runs[lanes]["film"] = film
    film = runs[S39_LANES].pop("film")
    runs[8 * S39_LANES].pop("film")
    s3_max = float(film[..., 7].abs().max())
    lin_max = float((film[..., 5].abs() + film[..., 6].abs()).max()
                    / film[..., 4].max())
    assert s3_max == 0.0, s3_max
    assert lin_max > 1e-4, lin_max
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = stokes_samples(scene, 0)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    cmp = pool_vs_scan(film, rows, scene.config.spp)
    assert cmp["over_3se"] <= cmp["budget"], cmp
    assert all(abs(z) <= 3 for z in cmp["mean_z"].values()), cmp
    assert float(rows[:, 3].abs().max()) == 0.0
    rec["bench"] = dict(
        runs={str(k): v for k, v in runs.items()}, s3_max=s3_max,
        s1_s2_max=lin_max, scan_ms=scan_s * 1e3, pool_vs_scan=cmp)
    r = runs[S39_LANES]
    print(f"# 39a bench.py's polarized load on {S39_LANES} lanes: "
          f"{r['render_ms']:.1f} ms, {r['msamples_per_s']:.4f} Msamples/s, "
          f"iterations {r['iterations']}, host syncs {r['host_syncs']} "
          f"(+ the pool's {r['pool_syncs']}), fused tile_sweep launches "
          f"{r['launches']['tile_sweep']} = queries {r['queries']}; on "
          f"{8 * S39_LANES} lanes {runs[8 * S39_LANES]['render_ms']:.1f} ms "
          f"(iterations {runs[8 * S39_LANES]['iterations']}); S3 max "
          f"{s3_max}, max (|S1| + |S2|) / spp {lin_max:.4e}; the scan "
          f"driver's samples {scan_s * 1e3:.1f} ms; pool vs scan pixel "
          f"means (Y, S1..S3): {cmp['differing']} of {cmp['compared']} "
          f"differ, {cmp['over_3se']} beyond 3 standard errors (budget "
          f"{cmp['budget']}, largest z {cmp['z_max']:.2f}), z of the mean "
          f"difference {cmp['mean_z']}", flush=True)

    # ---- 39b. an isotropic phase: S0 is volpath's sample for sample ---------
    phase_clock("39b")
    iso = polarized_atmosphere(64, 4, phase={"type": "isotropic"},
                               integrator="volpath")
    cfg = iso.config
    total = cfg.film_height * cfg.film_width * cfg.spp
    smp, ray, _rw, _pos = integrators._camera_lanes(
        iso, 5, cfg.spp, torch.arange(total, dtype=torch.int64,
                                      device=iso.bsphere_center.device))
    t0 = time.perf_counter()
    spec, _v, _s = volpath.sample(iso, smp, ray)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stokes_v, _v2, _s2 = polarized_vol.sample_stokes(iso, smp, ray)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    s0 = stokes_v[..., 0]
    off = ~torch.isclose(s0, spec, rtol=1e-5, atol=1e-7).all(-1)
    assert float(spec.abs().max()) > 0.01
    assert float(stokes_v[..., 1:].abs().max()) == 0.0
    assert int(off.sum()) <= total // 1000, int(off.sum())
    rec["isotropic"] = dict(samples=total, off=int(off.sum()),
                            volpath_ms=(t1 - t0) * 1e3,
                            stokes_ms=(t2 - t1) * 1e3)
    print(f"# 39b isotropic phase 64x64 spp4: polarized_vol S0 against "
          f"volpath, sample for sample: {int(off.sum())} of {total} samples "
          f"beyond rtol 1e-5 (budget {total // 1000}); S1..S3 exactly 0; "
          f"volpath {(t1 - t0) * 1e3:.1f} ms, Mueller volpath "
          f"{(t2 - t1) * 1e3:.1f} ms (scan driver)", flush=True)

    # ---- 39c. the 64^3 grid under stokes(volpath) ---------------------------
    phase_clock("39c")
    large = polarized_atmosphere(64, 2, grid_res=(64, 64, 64))
    assert large.vol_packed is not None
    film, secs, launches, counts = counted_pool(large, S39_LANES)
    rec["large3d"] = check_atmosphere(
        "polarized 64^3 atmosphere 64x64 spp2 stokes(volpath) "
        f"({S39_LANES} lanes)", large, film[..., :5], secs, launches, counts)
    assert counts["lookups"] > 0
    assert float(film[..., 7].abs().max()) == 0.0

    # ---- 39d. pplastic terrain(256) under stokes(path) ----------------------
    phase_clock("39d")
    # max_depth 3 (terrain_scene's 6 elsewhere); the film through the plain
    # sweep is phase 40b's (32x32; here at 256x256 until phase 40 was
    # added): the plain sweep's time
    d = terrain_scene(V, F, 256, 256, 2, 3)
    d["terrain"]["bsdf"] = {"type": "pplastic", "alpha": 0.2,
                            "diffuse_reflectance": [0.3, 0.4, 0.5]}
    d["integrator"] = {"type": "stokes", "child": d["integrator"]}
    terr = load_dict(d, Variant("rgb", polarized=True))
    integrators.render(terr, seed=3, spp=1)  # warm-up
    film_k, secs, got = counted_scan(terr, seed=3)
    la = got["launches"]
    assert la["tile_sweep"] == got["queries"] > 0, got
    assert sum(la.values()) == la["tile_sweep"], la
    n = 256 * 256 * 2
    rec["terrain"] = dict(
        render_ms=secs * 1e3, msamples_per_s=n / secs / 1e6,
        queries=got["queries"], launches=la["tile_sweep"],
        host_syncs=got["host_syncs"],
        s1_s2_max=float((film_k[..., 5:7].abs()
                         / film_k[..., 4:5]).max()))
    assert rec["terrain"]["s1_s2_max"] > 1e-3
    print(f"# 39d pplastic terrain(256) 256x256 spp2 max_depth 3 "
          f"stokes(path) (scan): "
          f"{secs * 1e3:.1f} ms, {n / secs / 1e6:.4f} Msamples/s, "
          f"tile_sweep launches {la['tile_sweep']} = queries, host syncs "
          f"{got['host_syncs']}; max |S1|, |S2| / S0 weight "
          f"{rec['terrain']['s1_s2_max']:.4f} (the plain sweep's film: 40b)",
          flush=True)

    # ---- 39e. the optical bench's gates (analytic shapes, no kernel) --------
    phase_clock("39e")

    def bench(elements):
        b = {"type": "scene",
             "integrator": {"type": "stokes",
                            "child": {"type": "path", "max_depth": 2}},
             "sensor": {"type": "radiancemeter",
                        "to_world": {"type": "look_at",
                                     "origin": [0, 0, -4],
                                     "target": [0, 0, 1], "up": [0, 1, 0]},
                        "film": {"width": 1, "height": 1,
                                 "rfilter": {"type": "box"}},
                        "sampler": {"sample_count": 64}},
             "env": {"type": "constant", "radiance": 1.0}}
        for i, el in enumerate(elements):
            b[f"el{i}"] = {"type": "rectangle",
                           "to_world": {"type": "translate",
                                        "value": [0, 0, -3.0 + i]},
                           "bsdf": el}
        with counting() as read:
            img = integrators.render(load_dict(b, Variant(
                "rgb", polarized=True)), seed=1)
            launched = sum(read()["launches"].values())
        assert launched == 0, launched
        return float(img[0, 0, 1])

    pol = lambda theta: {"type": "polarizer", "theta": theta}
    gates = {}
    for theta in (0.0, 30.0, 60.0, 90.0):
        got = bench([pol(0.0), pol(theta)])
        want = 0.5 * np.cos(np.deg2rad(theta)) ** 2
        assert abs(got - want) < 1e-4, (theta, got, want)
        gates[f"malus {theta:g}"] = got
    gates["crossed"] = bench([pol(0.0), pol(90.0)])
    assert abs(gates["crossed"]) < 1e-4, gates
    gates["crossed with a half-wave plate at 45"] = bench([
        pol(0.0), {"type": "retarder", "theta": 45.0, "delta": 180.0},
        pol(90.0)])
    assert abs(gates["crossed with a half-wave plate at 45"] - 0.5) < 1e-4
    rec["gates"] = gates
    print(f"# 39e optical bench on the card (no kernel): {gates} "
          f"(Malus 0.5 cos^2, crossed 0, half-wave 0.5; within 1e-4)",
          flush=True)
    return rec


def slice_6e_launches(rec, kernel):
    """``kernel``'s launches in each render of phase 39."""
    out = {f"bench polarized {k} lanes": v["launches"][kernel]
           for k, v in rec["bench"]["runs"].items()}
    out["64^3 stokes(volpath)"] = rec["large3d"]["launches"][kernel]
    if kernel == "tile_sweep":
        out["pplastic terrain stokes(path) (sorted)"] = rec["terrain"][
            "launches"]
    return out


# ---- phase 40: the stokes gradients, harnesses, hooks, native builders -------

S40_LANES = 1 << 15


@contextlib.contextmanager
def numpy_builders():
    """Inside the block, scenes build their tiles and binary BVHs with the
    numpy plain versions of the native builders."""
    from eradiate_kernel_tpu_torch.ops import accel, bvh
    from eradiate_kernel_tpu_torch.scene import build

    saved = accel.build_tri_tiles, build.build_tile_bvh
    accel.build_tri_tiles = accel._build_tiles_numpy
    build.build_tile_bvh = bvh._build_tile_bvh_numpy
    try:
        yield
    finally:
        accel.build_tri_tiles, build.build_tile_bvh = saved


def user_plugins():
    """A user's plugins, written as tests/test_custom_plugins.py's: an HG
    clone whose anisotropy is named ``anisotropy``, a point-emitter clone
    taking a ``power``, a diffuse clone whose reflectance is named
    ``albedo`` and an integrator whose sample is path's. Returns name ->
    (register function, registries to take it out of, module)."""
    import types

    from eradiate_kernel_tpu_torch import bsdfs, emitters, integrators, phase
    from eradiate_kernel_tpu_torch.bsdfs import diffuse
    from eradiate_kernel_tpu_torch.integrators import path

    hg = types.SimpleNamespace()
    hg.build = lambda props, b: {
        "aniso": np.float32(props.get("anisotropy", 0.0))}

    def eval_cos(params, slot, ct):
        g = params["aniso"][slot]
        temp = 1.0 + g * g + 2.0 * g * ct
        return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / torch.clamp(
            temp * torch.sqrt(torch.clamp(temp, min=0.0)), min=1e-12)

    def sample_cos(params, slot, s1):
        g = params["aniso"][slot]
        safe_g = torch.where(torch.abs(g) < 1e-4, 1e-4, g)
        sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * s1)
        ct = (1.0 + g * g - sqr_term * sqr_term) / (2.0 * safe_g)
        return torch.where(torch.abs(g) < 1e-4, 1.0 - 2.0 * s1, ct)

    hg.eval_cos, hg.sample_cos = eval_cos, sample_cos
    lamp = types.SimpleNamespace(
        sample_direction=emitters.point_sample_direction,
        build=lambda props, b: {
            "position": np.asarray(props.get("position", [0, 0, 0]),
                                   np.float32),
            "intensity": np.int32(b.texture(
                float(props.get("power", 1.0)) / (4.0 * np.pi),
                emitter=True))})
    clone = types.SimpleNamespace(
        FLAGS=diffuse.FLAGS, sample=diffuse.sample,
        eval_pdf=diffuse.eval_pdf,
        build=lambda props, b: diffuse.build(
            {**props, "reflectance": props.get("albedo", 0.5)}, b))
    return {
        "user_hg": (phase.register_phasefunction, (phase.CUSTOM,), hg),
        "user_lamp": (emitters.register_emitter,
                      (emitters.CUSTOM, emitters.KIND_SAMPLERS), lamp),
        "user_diffuse": (bsdfs.register_bsdf, (bsdfs.REGISTRY,), clone),
        "user_path": (integrators.register_integrator,
                      (integrators.REGISTRY,),
                      types.SimpleNamespace(sample=path.sample)),
    }


def scan_value_grad(scene, keys, legs):
    """The scan driver's value+grad of the developed film's mean with
    respect to ``keys`` (autograd through integrators.render(regen=False),
    the drivers' only backward for stokes), once under each context of
    ``legs`` (name -> context manager), each leg's film held bit for bit to
    the primal render's. Returns ({leg: record}, {leg: {key: grad}})."""
    from eradiate_kernel_tpu_torch import films, integrators
    from eradiate_kernel_tpu_torch.utils import autodiff

    primal = integrators.render(scene, seed=0, develop_film=False)
    recs, grads = {}, {}
    for leg, ctx in legs.items():
        pm = autodiff.traverse(scene).keep(keys)
        params = pm.trainable()
        with ctx(), counting() as read:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            film = integrators.render(pm.with_trainable(params), seed=0,
                                      develop_film=False)
            loss = films.develop(film).mean()
            torch.cuda.synchronize()
            fwd = read()
            loss.backward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            end = read()
        assert torch.equal(film.detach(), primal), f"{leg}: film"
        grads[leg] = {k: p.grad for k, p in params.items()}
        recs[leg] = dict(
            value_grad_ms=secs * 1e3, queries=fwd["queries"],
            lookups=fwd["lookups"], forward=fwd["launches"],
            backward={k: v - fwd["launches"][k]
                      for k, v in end["launches"].items()},
            host_syncs=end["host_syncs"],
            peak_bytes=torch.cuda.max_memory_allocated())
    return recs, grads


def grads_agree(grads, ref_leg="plain"):
    """Every key's gradient through the kernels within rtol 1e-5, atol
    1e-7 of ``ref_leg``'s (phase 14's tolerance) on their finite entries,
    finite at the same entries, not all zero. Returns the largest
    difference."""
    worst = 0.0
    for k, g in grads["kernels"].items():
        ref = grads[ref_leg][k]
        ok = torch.isfinite(ref)
        assert torch.equal(ok, torch.isfinite(g)), k
        assert bool(g[ok].abs().sum() > 0), k
        torch.testing.assert_close(g[ok], ref[ok], rtol=1e-5, atol=1e-7)
        worst = max(worst, float((g[ok] - ref[ok]).abs().max()))
    return worst


def slice_7b_phases(V, F):
    """Phase 40 (slices 6e-2 and 7b). (a) The 64^3 atmosphere under
    stokes(volpath) at 64x64 spp 2 max_depth 8: value+grad with respect to
    the grid and the medium's albedo on the scan driver through the
    kernels and through the plain gather: grid_gather launches == lookups
    forward, grid_trilinear_bwd launches == lookups backward, gradients
    within rtol 1e-5, atol 1e-7. (b) The pplastic terrain(256) under
    stokes(path) at 32x32 spp 2 max_depth 2: value+grad with respect to
    the rgb spectra on the scan driver, sorted sweep against the plain
    sweep, launches == queries. (c) The native builders: terrain(256)'s
    tiles and the forest's binary and 8-wide BVHs bit-equal to the numpy
    plain versions (both builds' host times), renders over the native-built
    accelerators bit-equal to the numpy-built ones' (terrain through
    tile_sweep, the forest through tile_bvh and tile_bvh8); the native
    builders must have run. (d) The user hooks: an HG clone in the 64^3
    atmosphere on the lane pool against the built-in hg (1e-5), a diffuse
    clone on terrain(256) against diffuse, a point-emitter clone and a
    path clone against theirs. (e) The chi2 harness on the card: hg,
    rayleigh, tabphase, rpv, pplastic and the HG clone. (f) The z-test
    harness on the flagship atmosphere (its 256x256 film cut to 32x32) at
    the harness's defaults (64 spp against a 512-spp reference) on the
    lane pool, and its detection of an albedo of 0.45 for 0.9. (g) DWAA and
    DWAB files through the OpenEXR bridge, or "exr_bridge: absent" and
    the refusal. Returns the records."""
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.ops import accel, bvh, gather, intersect
    from eradiate_kernel_tpu_torch.scene import build, load_dict
    from eradiate_kernel_tpu_torch.utils import bitmap, chi2, ztest
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    polarized = Variant("rgb", polarized=True)
    rec = {}

    # ---- 40a. the 64^3 grid under stokes(volpath): value+grad, scan ---------
    phase_clock("40a")
    d = atmosphere(64, 64, 2, 8, grid_res=(64, 64, 64))
    d["integrator"] = {"type": "stokes", "child": {
        "type": "volpath", "max_depth": 8, "nee_transmittance": "residual"}}
    large = load_dict(d, polarized)
    keys = ["volumes.gridvolume.grid", "volumes.constvolume.value"]
    vg, grads = scan_value_grad(large, keys, {
        "kernels": contextlib.nullcontext, "plain": gather.use_plain})
    k, p = vg["kernels"], vg["plain"]
    assert k["forward"]["grid_gather"] == k["lookups"] > 0, k
    assert k["backward"]["grid_trilinear_bwd"] == k["lookups"], k
    assert k["backward"]["grid_gather"] == 0, k
    assert k["forward"]["tile_sweep"] == k["queries"] > 0, k
    assert p["forward"]["grid_gather"] == p["backward"][
        "grid_trilinear_bwd"] == 0, p
    rec["stokes_volpath_value_grad"] = dict(
        vg, grad_max_abs_err_vs_plain=grads_agree(grads),
        grad_abs_sums={kk: float(g.abs().sum())
                       for kk, g in grads["kernels"].items()})
    print(f"# 40a 64^3 stokes(volpath) 64x64 spp2 max_depth 8 value+grad "
          f"(scan): {k['value_grad_ms']:.1f} ms (plain gather "
          f"{p['value_grad_ms']:.1f} ms), lookups {k['lookups']} = "
          f"grid_gather launches = grid_trilinear_bwd launches, tile_sweep "
          f"{k['forward']['tile_sweep']} = queries, peak "
          f"{k['peak_bytes'] / 2**30:.2f} GiB; grid and albedo gradients "
          f"within {rec['stokes_volpath_value_grad']['grad_max_abs_err_vs_plain']:.2e}"
          f" of the plain versions'", flush=True)

    # ---- 40b. pplastic terrain(256) under stokes(path): value+grad, scan ----
    phase_clock("40b")
    # 32x32 spp 2 max_depth 2: the plain sweep's time; each leg's film is
    # the primal's bit for bit, so the plain sweep's is the kernel's (39d's
    # check, moved here)
    d = terrain_scene(V, F, 32, 32, 2, 2)
    d["terrain"]["bsdf"] = {"type": "pplastic", "alpha": 0.2,
                            "diffuse_reflectance": [0.3, 0.4, 0.5]}
    d["integrator"] = {"type": "stokes", "child": d["integrator"]}
    terr = load_dict(d, polarized)
    vg, grads = scan_value_grad(terr, ["spectra.baked.value"], {
        "kernels": contextlib.nullcontext, "plain": intersect.use_plain})
    k, p = vg["kernels"], vg["plain"]
    assert k["forward"]["tile_sweep"] == k["queries"] > 0, k
    assert sum(k["forward"].values()) == k["queries"], k
    assert sum(k["backward"].values()) == 0, k
    assert sum(p["forward"].values()) == sum(p["backward"].values()) == 0
    rec["stokes_path_value_grad"] = dict(
        vg, grad_max_abs_err_vs_plain=grads_agree(grads))
    print(f"# 40b pplastic terrain(256) 32x32 spp2 max_depth 2 stokes(path) "
          f"value+grad (scan): {k['value_grad_ms']:.1f} ms (plain sweep "
          f"{p['value_grad_ms']:.1f} ms), tile_sweep launches "
          f"{k['forward']['tile_sweep']} = queries (sorted), none in the "
          f"backward; gradients within "
          f"{rec['stokes_path_value_grad']['grad_max_abs_err_vs_plain']:.2e}"
          f" of the plain sweep's", flush=True)

    # ---- 40c. the native tile and BVH builders -------------------------------
    phase_clock("40c")
    # a quiet fallback to numpy shows here: None where there is no g++
    assert accel._builder() is not None and bvh._builder() is not None
    t0 = time.perf_counter()
    native = accel.build_tri_tiles(V, F)
    t1 = time.perf_counter()
    plain = accel._build_tiles_numpy(V, F)
    t2 = time.perf_counter()
    assert len(native[1]) == -(-len(F) // accel.TILE_K)  # 1,017
    assert all(np.array_equal(a, b) for a, b in zip(native, plain))
    builds = {"terrain(256) tiles": dict(native_s=t1 - t0,
                                         numpy_s=t2 - t1)}
    # the forest's leaves, as its load_dict hands them to the BVH builder
    leaves = []
    build_tile_bvh = build.build_tile_bvh

    def recorded(*a, **kw):
        leaves.append(a)
        return build_tile_bvh(*a, **kw)

    build.build_tile_bvh = recorded
    try:
        forest_n = load_dict(forest_scene(64, 64, 2, 2))
    finally:
        build.build_tile_bvh = build_tile_bvh
    t0 = time.perf_counter()
    nb = bvh.build_tile_bvh(*leaves[0])
    t1 = time.perf_counter()
    pb = bvh._build_tile_bvh_numpy(*leaves[0])
    t2 = time.perf_counter()
    assert all(np.array_equal(a, b) for a, b in zip(nb, pb))
    w8n, w8p = bvh.collapse_to_bvh8(nb[0], nb[1]), bvh.collapse_to_bvh8(
        pb[0], pb[1])
    assert all(np.array_equal(a, b) for a, b in zip(w8n, w8p))
    builds["forest BVH"] = dict(native_s=t1 - t0, numpy_s=t2 - t1,
                                leaves=len(leaves[0][0]), depth=int(nb[2]),
                                nodes=len(nb[1]), nodes8=len(w8n[0]))
    with numpy_builders():
        forest_p = load_dict(forest_scene(64, 64, 2, 2))
        terr_p = load_dict(terrain_scene(V, F, 64, 64, 2, 3))
    terr_n = load_dict(terrain_scene(V, F, 64, 64, 2, 3))
    for a, b in ((terr_n, terr_p), (forest_n, forest_p)):
        ta, tb = a.tensors(), b.tensors()
        assert all(torch.equal(ta[kk], tb[kk]) for kk in ta
                   if kk.startswith("geo.")), "scene arrays"
    renders = {}
    for label, (sn, sp), wide, kernel in (
            ("terrain", (terr_n, terr_p), "0", "tile_sweep"),
            ("forest", (forest_n, forest_p), "0", "tile_bvh"),
            ("forest", (forest_n, forest_p), "1", "tile_bvh8")):
        with env(ERT_BVH_WIDE=wide):
            film_n, secs, got = counted_scan(sn, seed=2)
            film_p, _s, got_p = counted_scan(sp, seed=2)
        for g in (got, got_p):
            assert g["launches"][kernel] == g["queries"] > 0, (label, g)
        assert torch.equal(film_n, film_p), (label, kernel)
        renders[f"{label} {kernel}"] = dict(render_ms=secs * 1e3,
                                            launches=got["launches"][kernel],
                                            queries=got["queries"])
    rec["native_builders"] = dict(builds=builds, renders=renders)
    print(f"# 40c native builders: terrain(256) tiles "
          f"{builds['terrain(256) tiles']['native_s'] * 1e3:.1f} ms native, "
          f"{builds['terrain(256) tiles']['numpy_s'] * 1e3:.1f} ms numpy; "
          f"the forest's BVH ({builds['forest BVH']['leaves']} leaves, depth "
          f"{builds['forest BVH']['depth']}) "
          f"{builds['forest BVH']['native_s'] * 1e3:.1f} ms native, "
          f"{builds['forest BVH']['numpy_s'] * 1e3:.1f} ms numpy; tiles, "
          f"BVH and 8-wide BVH bit-equal; renders over the native-built "
          f"accelerators bit-equal to the numpy-built ones': "
          f"{ {kk: v['launches'] for kk, v in renders.items()} } launches "
          f"(= queries)", flush=True)

    # ---- 40d. the user hooks --------------------------------------------------
    phase_clock("40d")
    plugins = user_plugins()
    for name, (register, _regs, module) in plugins.items():
        register(name, module)
    hooks = {}
    try:
        def atmo(phase):
            d = atmosphere(64, 64, 2, 8, grid_res=(64, 64, 64))
            d["integrator"]["nee_transmittance"] = "residual"
            d["atmo"]["interior"]["phase"] = phase
            return load_dict(d)

        films = {}
        for label, ph in (("hg", {"type": "hg", "g": 0.4}),
                          ("user_hg", {"type": "user_hg",
                                       "anisotropy": 0.4})):
            film, secs, launches, counts = counted_pool(atmo(ph), S40_LANES)
            assert launches["grid_gather"] == counts["lookups"] > 0, counts
            films[label] = film
            hooks[f"64^3 {label} pool"] = dict(
                render_ms=secs * 1e3, launches=launches["grid_gather"],
                lookups=counts["lookups"])
        torch.testing.assert_close(films["user_hg"], films["hg"], rtol=0,
                                   atol=1e-5)
        # a diffuse clone on terrain(256), and a path clone
        surface = {}
        for label, bsdf, kind in (
                ("diffuse", {"type": "diffuse", "reflectance": 0.5}, "path"),
                ("user_diffuse", {"type": "user_diffuse", "albedo": 0.5},
                 "path"),
                ("user_path", {"type": "diffuse", "reflectance": 0.5},
                 "user_path")):
            d = terrain_scene(V, F, 64, 64, 2, 3)
            d["terrain"]["bsdf"] = bsdf
            d["integrator"]["type"] = kind
            film, secs, got = counted_scan(load_dict(d), seed=4)
            assert got["launches"]["tile_sweep"] == got["queries"] > 0, got
            surface[label] = film
            hooks[f"terrain {label}"] = dict(
                render_ms=secs * 1e3, launches=got["launches"]["tile_sweep"])
        assert torch.equal(surface["user_diffuse"], surface["diffuse"])
        assert torch.equal(surface["user_path"], surface["diffuse"])

        def lamp_scene(lamp):
            return {"type": "scene",
                    "integrator": {"type": "path", "max_depth": 3},
                    "sensor": {"type": "perspective", "fov": 30.0,
                               "to_world": {"type": "look_at",
                                            "origin": [0, 0, 4],
                                            "target": [0, 0, 0],
                                            "up": [0, 1, 0]},
                               "film": {"width": 64, "height": 64,
                                        "rfilter": {"type": "box"}},
                               "sampler": {"sample_count": 32}},
                    "surf": {"type": "rectangle",
                             "bsdf": {"type": "diffuse",
                                      "reflectance": 0.5}},
                    "lamp": lamp}

        ref = integrators.render(load_dict(lamp_scene(
            {"type": "point", "position": [0, 0, 2.5], "intensity": 0.8})),
            seed=11)
        got = integrators.render(load_dict(lamp_scene(
            {"type": "user_lamp", "position": [0, 0, 2.5],
             "power": 4.0 * np.pi * 0.8})), seed=11)
        assert float(ref.mean()) > 1e-3
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
        hooks["lamp max abs diff"] = float((got - ref).abs().max())
        hooks["hg max abs diff"] = float(
            (films["user_hg"] - films["hg"]).abs().max())

        # ---- 40e. the chi2 harness on the card --------------------------------
        phase_clock("40e")
        sphere, upper = chi2.SphericalDomain(), chi2.SphericalDomain((0, 1))
        tab = {"type": "tabphase",
               "values": [0.5, 0.6, 0.8, 1.1, 1.6, 2.4, 3.6, 5.0]}
        cases = {
            # tests/test_volpath.py's blendphase settings
            "hg": (chi2.PhaseFunctionAdapter({"type": "hg", "g": 0.6}),
                   sphere, 200_000, 41),
            "rayleigh": (chi2.PhaseFunctionAdapter({"type": "rayleigh"}),
                         sphere, 200_000, 41),
            "tabphase": (chi2.PhaseFunctionAdapter(tab), sphere, 200_000,
                         41),
            # tests/test_eradiate_oracles.py's and tests/test_bsdfs.py's
            "rpv": (chi2.BSDFAdapter({"type": "rpv", "rho_0": 0.3, "k": 0.7,
                                      "g": -0.2}), upper, 150_000, 64),
            "pplastic": (chi2.BSDFAdapter({"type": "pplastic",
                                           "alpha": 0.2}), upper, 150_000,
                         64),
            # tests/test_custom_plugins.py's
            "user_hg": (chi2.PhaseFunctionAdapter(
                {"type": "user_hg", "anisotropy": 0.6}), sphere, 120_000,
                32),
        }
        chi = {}
        for name, (adapter, domain, n, res) in cases.items():
            t0 = time.perf_counter()
            test = chi2.ChiSquareTest(domain, *adapter, sample_count=n,
                                      res=res, ires=9)
            ok = test.run(0.01)
            chi[name] = dict(p_value=float(test.p_value), samples=n,
                             seconds=time.perf_counter() - t0)
            assert ok, (name, test.messages)
        rec["chi2"] = chi
        print(f"# 40e chi2 on the card (samples and pdf on the card, tables "
              f"on the host): "
              f"{ {kk: (round(v['p_value'], 4), round(v['seconds'], 2)) for kk, v in chi.items()} }"
              f" (p-value, s)", flush=True)
    finally:
        for name, (_register, regs, _module) in plugins.items():
            for reg in regs:
                reg.pop(name, None)
    rec["hooks"] = hooks
    print(f"# 40d hooks: HG clone in the 64^3 atmosphere (pool) within "
          f"{hooks['hg max abs diff']:.1e} of hg, "
          f"{hooks['64^3 user_hg pool']['launches']} grid_gather launches "
          f"= lookups; diffuse and path clones on terrain(256) bit-equal to "
          f"diffuse and path ({hooks['terrain user_diffuse']['launches']} "
          f"tile_sweep launches); point clone within "
          f"{hooks['lamp max abs diff']:.1e}", flush=True)

    # ---- 40f. the z-test harness on the flagship atmosphere -----------------
    phase_clock("40f")
    out = os.path.join("smoke_out", "ztest")
    # 32x32 (the flagship's 256x256: the time limit)
    flag = atmosphere(32, 32, 64, 12, grid_res=64)
    flag["integrator"]["nee_transmittance"] = "residual"
    pool_kw = dict(regen=True, samples_per_pass=S40_LANES)
    t0 = time.perf_counter()
    ok, frac, _p = ztest.check_scene(flag, out, "flagship", regenerate=True,
                                     **pool_kw)
    self_s = time.perf_counter() - t0
    assert ok, frac
    bad = atmosphere(32, 32, 64, 12, grid_res=64, albedo=0.45)
    bad["integrator"]["nee_transmittance"] = "residual"
    ok_bad, frac_bad, _p = ztest.check_scene(bad, out, "flagship", **pool_kw)
    assert not ok_bad, frac_bad
    rec["ztest"] = dict(pass_fraction=frac, seconds=self_s,
                        changed_albedo_pass_fraction=frac_bad)
    print(f"# 40f z-test, flagship 32x32 spp 64 against 512 (pool): passes "
          f"{frac:.4f} of pixel-channels ({self_s:.1f} s with its "
          f"reference); albedo 0.45 for 0.9 fails, {frac_bad:.4f} pass",
          flush=True)

    # ---- 40g. the OpenEXR bridge ------------------------------------------------
    phase_clock("40g")
    img = np.random.default_rng(7).random((64, 48, 3)).astype(np.float32)
    missing = bitmap._bridge_missing()
    os.makedirs(out, exist_ok=True)
    if missing is None:
        got = {}
        for comp, code in (("dwaa", 8), ("dwab", 9)):
            path = os.path.join(out, f"{comp}.exr")
            bitmap.write_exr(path, img, compression=comp, pixel_type="f16")
            with open(path, "rb") as f:
                head = f.read(4096)
            key = b"compression\x00compression\x00\x01\x00\x00\x00"
            assert head[head.index(key) + len(key)] == code, comp
            back, names = bitmap.read_exr(path)
            assert names == ["R", "G", "B"] and back.shape == img.shape
            got[comp] = float(np.abs(back - img).max())
            assert got[comp] < 0.05, got
        rec["exr_bridge"] = dict(present=True, max_abs_err=got)
        print(f"# 40g exr_bridge: present; DWAA and DWAB written and read "
              f"back (max abs err {got})", flush=True)
    else:
        path = os.path.join(out, "zip.exr")
        bitmap.write_exr(path, img)
        data = bytearray(open(path, "rb").read())
        key = b"compression\x00compression\x00\x01\x00\x00\x00"
        data[data.index(key) + len(key)] = 8
        with open(path, "wb") as f:
            f.write(bytes(data))
        try:
            bitmap.read_exr(path)
            raise AssertionError("a DWAA file read without libOpenEXR")
        except NotImplementedError as e:
            assert "libOpenEXR" in str(e), e
        rec["exr_bridge"] = dict(present=False, reason=missing)
        print(f"exr_bridge: absent ({missing}); DWAA refused, naming "
              f"libOpenEXR", flush=True)
    return rec


def slice_7b_launches(rec, kernel):
    """``kernel``'s launches in each render and value+grad of phase 40."""
    out = {}
    for leg in ("stokes_volpath_value_grad", "stokes_path_value_grad"):
        k = rec[leg]["kernels"]
        out[f"{leg} forward"] = k["forward"].get(kernel, 0)
        out[f"{leg} backward"] = k["backward"].get(kernel, 0)
    for label, r in rec["native_builders"]["renders"].items():
        if label.endswith(" " + kernel):
            out[f"native-built {label}"] = r["launches"]
    if kernel == "grid_gather":
        out["64^3 user_hg pool"] = rec["hooks"]["64^3 user_hg pool"][
            "launches"]
    if kernel == "tile_sweep":
        out["terrain user_diffuse"] = rec["hooks"]["terrain user_diffuse"][
            "launches"]
        out["terrain user_path"] = rec["hooks"]["terrain user_path"][
            "launches"]
    return out



# phase 41's pool width (phase 10's) and the children's time limit
S41_LANES = 1 << 15
S41_CHILD_TIMEOUT = 300


def large3d_scene(width=256, height=256, spp=4, max_depth=12):
    """bench.py's large3d as phase 10 loads it: the atmosphere with a 64^3
    grid and residual NEE transmittance, on the card."""
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(width, height, spp, max_depth, grid_res=(64, 64, 64))
    d["integrator"]["nee_transmittance"] = "residual"
    return load_dict(d)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def allreduce_ms(film, reps=20):
    """Host ms a dist.all_reduce of a tensor shaped as ``film`` (every rank
    in turn, synchronised before and after), after one warm-up."""
    import torch.distributed as dist

    buf = torch.zeros_like(film)
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def sharded_pool_render(mesh):
    """render_sharded(regen=True) of large3d over ``mesh`` (pools of
    S41_LANES lanes) under counting(): (film on the host, record)."""
    from eradiate_kernel_tpu_torch.parallel import render_sharded

    scene = large3d_scene()
    with counting() as read:
        t0 = time.perf_counter()
        film = render_sharded(scene, mesh, seed=0, regen=True,
                              regen_lanes=S41_LANES, develop_film=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read()
    return film.cpu(), dict(
        render_ms=secs * 1e3, shards=mesh.size,
        local_shards=len(mesh.devices),
        queries=got["queries"], lookups=got["lookups"],
        launches={k: got["launches"][k]
                  for k in ("tile_sweep", "grid_gather")},
        allreduce_ms=allreduce_ms(film))


def sharded_value_grad(mesh, steps=False):
    """sharded_film's value+grad of the developed film's mean with respect
    to the 64^3 grid and the albedo of large3d at 64x64 spp 2 max_depth 6
    (the scan driver), under counting(); with ``steps`` one Adam step
    after it. Returns ({key: gradient on the host}, record)."""
    from eradiate_kernel_tpu_torch import films
    from eradiate_kernel_tpu_torch.parallel import sharded_film
    from eradiate_kernel_tpu_torch.utils import autodiff

    pm = autodiff.traverse(large3d_scene(64, 64, 2, 6))
    pm.keep(["volumes.gridvolume.grid", "volumes.constvolume.value"])
    opt = autodiff.Adam(pm.trainable(), lr=1e-2)
    with counting() as read:
        t0 = time.perf_counter()
        film = sharded_film(pm.with_trainable(opt.params), mesh, 0, 2)
        loss = films.develop(film).mean()
        torch.cuda.synchronize()
        fwd = read()
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        end = read()
    grads = {k: p.grad.cpu() for k, p in opt.params.items()}
    rec = dict(value_grad_ms=secs * 1e3, loss=float(loss.detach()),
               lookups=fwd["lookups"], queries=fwd["queries"],
               forward={k: fwd["launches"][k]
                        for k in ("tile_sweep", "grid_gather")},
               backward_grid_trilinear_bwd=end["launches"][
                   "grid_trilinear_bwd"] - fwd["launches"][
                   "grid_trilinear_bwd"])
    if steps:
        before = {k: p.detach().clone() for k, p in opt.params.items()}
        opt.step()
        rec["adam_step_finite"] = all(
            bool(torch.isfinite(p).all()) for p in opt.params.values())
        rec["adam_step_moved"] = any(
            not torch.equal(p.detach(), before[k])
            for k, p in opt.params.items())
    return grads, rec


def s41_nccl_rank(rank, world, address, out_dir):
    """Phase 41a on one rank of an NCCL group of ``world`` (one process a
    card): the sharded large3d pool render over two shards on this rank's
    card. Returns (or with ``out_dir`` saves) its film and record."""
    import torch.distributed as dist

    from eradiate_kernel_tpu_torch.parallel import (init_distributed,
                                                    make_mesh)

    init_distributed(address, world, rank)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh([torch.device("cuda", torch.cuda.current_device())]
                         * 2)
        film, rec = sharded_pool_render(mesh)
        rec.update(backend="nccl", world=world, rank=rank)
    finally:
        dist.destroy_process_group()
    if out_dir is None:
        return film, rec
    torch.save((film, rec), os.path.join(out_dir, f"nccl{rank}.pt"))
    return None


def s41_child(rank, store, out):
    """Phase 41b in one of two processes sharing the card (gloo, one shard
    each; run as ``chip_smoke.py --s41-child RANK STORE OUT``): the sharded
    large3d pool render, then sharded_film's value+grad at 64x64 and one
    Adam step; saves the films, gradients and records to ``out``."""
    import torch.distributed as dist

    from eradiate_kernel_tpu_torch.parallel import (init_distributed,
                                                    make_mesh)

    torch.set_num_threads(1)
    init_distributed(f"file://{store}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh()  # this rank's card: cuda:LOCAL_RANK
        assert mesh.devices == (torch.device("cuda", 0),) and mesh.size == 2
        film, rec = sharded_pool_render(mesh)
        grads, vg = sharded_value_grad(mesh, steps=True)
        rec.update(backend=dist.get_backend(), world=2, rank=rank,
                   value_grad=vg)
    finally:
        dist.destroy_process_group()
    torch.save((film, grads, rec), out)
    return 0


def slice_7c_phases(large_film):
    """Phase 41 (slice 7c): parallel/ over torch.distributed on the card.
    (a) NCCL: a process group of one process a card (on one card the
    script itself, a world of 1), each rank's mesh two shards on its card;
    render_sharded(regen=True) of phase 10's large3d (256x256 spp 4, pools
    of 32,768 lanes) bit-equal to phase 10's film (each pixel's samples lie
    in one shard: the ranges are multiples of spp), tile_sweep launches ==
    closest-hit queries and grid_gather launches == lookups over the
    shards, the film's all_reduce timed. (b) Two processes sharing the
    card (gloo; NCCL refuses two ranks on one GPU), one shard each: the
    same render split between them, each rank's film bit-equal to the
    other's and to phase 10's; sharded_film's value+grad of the 64^3 grid
    and the albedo at 64x64 spp 2 max_depth 6 (the scan driver) on every
    rank within rtol 1e-5, atol 1e-7 of the script's one-shard value+grad
    (the scan's index_put_ atomics add in any order on the card),
    grid_trilinear_bwd launches == the lookups; one Adam step with a
    finite loss. Returns the records."""
    import tempfile

    from eradiate_kernel_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    rec = {}

    # ---- 41a. NCCL: one process a card ----------------------------------------
    phase_clock("41a")
    n_cards = torch.cuda.device_count()
    address = f"localhost:{free_port()}"
    if n_cards == 1:
        films = [s41_nccl_rank(0, 1, address, None)]
    else:
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.spawn(s41_nccl_rank,
                                        args=(n_cards, address, tmp),
                                        nprocs=n_cards)
            films = [torch.load(os.path.join(tmp, f"nccl{r}.pt"))
                     for r in range(n_cards)]
    ranks = [r for _f, r in films]
    for film, _r in films:
        assert torch.equal(film, large_film.cpu()), "41a film"
    total = {k: sum(r["launches"][k] for r in ranks)
             for k in ("tile_sweep", "grid_gather")}
    queries = sum(r["queries"] for r in ranks)
    lookups = sum(r["lookups"] for r in ranks)
    assert total["tile_sweep"] == queries > 0, (total, queries)
    assert total["grid_gather"] == lookups > 0, (total, lookups)
    rec["nccl"] = dict(ranks=ranks, launches=total, queries=queries,
                       lookups=lookups)
    r0 = ranks[0]
    print(f"# 41a NCCL, {n_cards} rank(s), {r0['shards']} shards "
          f"({r0['local_shards']} a card): large3d 256x256 spp4 "
          f"render_sharded(regen=True) {r0['render_ms']:.1f} ms on rank 0, "
          f"film bit-equal to phase 10's; tile_sweep {total['tile_sweep']} "
          f"= queries, grid_gather {total['grid_gather']} = lookups; film "
          f"all_reduce (256x256x5 float32, 1.3 MB) "
          f"{', '.join(f'{r['allreduce_ms']:.4f}' for r in ranks)} ms",
          flush=True)

    # ---- 41b. two processes sharing the card: gloo ---------------------------
    phase_clock("41b")
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, LOCAL_RANK="0")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--s41-child",
             str(r), os.path.join(tmp, "store"), outs[r]], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            # the one-process value+grad while the children start
            one_grads, one = sharded_value_grad(make_mesh(["cuda:0"]))
            logs = [p.communicate(timeout=S41_CHILD_TIMEOUT)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        children_s = time.perf_counter() - t0
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"41b child failed:\n{log[-4000:]}"
        got = [torch.load(o) for o in outs]
    assert one["lookups"] > 0
    assert one["forward"]["grid_gather"] == one["lookups"], one
    assert one["backward_grid_trilinear_bwd"] == one["lookups"], one
    worst = 0.0
    for film, grads, r in got:
        assert r["backend"] == "gloo" and r["shards"] == 2, r
        assert torch.equal(film, got[0][0]), "41b films differ"
        assert torch.equal(film, large_film.cpu()), "41b film"
        assert r["launches"]["tile_sweep"] == r["queries"] > 0, r
        assert r["launches"]["grid_gather"] == r["lookups"] > 0, r
        vg = r["value_grad"]
        assert vg["forward"]["grid_gather"] == vg["lookups"] > 0, vg
        assert vg["backward_grid_trilinear_bwd"] == vg["lookups"], vg
        assert vg["adam_step_finite"] and vg["adam_step_moved"], vg
        assert np.isfinite(vg["loss"]) and abs(
            vg["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"]), vg
        for k, g in grads.items():
            ref = one_grads[k]
            ok = torch.isfinite(ref)
            assert torch.equal(ok, torch.isfinite(g)), k
            assert bool(g[ok].abs().sum() > 0), k
            torch.testing.assert_close(g[ok], ref[ok], rtol=1e-5, atol=1e-7)
            worst = max(worst, float((g[ok] - ref[ok]).abs().max()))
    assert torch.equal(got[0][1]["volumes.gridvolume.grid"],
                       got[1][1]["volumes.gridvolume.grid"])
    rec["gloo_shared_card"] = dict(
        ranks=[r for _f, _g, r in got], one_process=one,
        grad_max_abs_err_vs_one_process=worst, children_s=children_s)
    rs = [r for _f, _g, r in got]
    print(f"# 41b two processes sharing the card (gloo, one shard each; "
          f"NCCL refuses two ranks on one GPU): large3d pool render "
          f"{', '.join(f'{r['render_ms']:.1f}' for r in rs)} ms, films "
          f"equal and bit-equal to phase 10's; launches tile_sweep "
          f"{[r['launches']['tile_sweep'] for r in rs]} = queries, "
          f"grid_gather {[r['launches']['grid_gather'] for r in rs]} = "
          f"lookups; film all_reduce "
          f"{', '.join(f'{r['allreduce_ms']:.3f}' for r in rs)} ms; 64^3 "
          f"64x64 spp2 sharded_film value+grad "
          f"{', '.join(f'{r['value_grad']['value_grad_ms']:.1f}' for r in rs)}"
          f" ms (one process {one['value_grad_ms']:.1f} ms), "
          f"grid_trilinear_bwd {[r['value_grad']['backward_grid_trilinear_bwd'] for r in rs]}"
          f" = lookups, gradients within {worst:.2e} of the one-process "
          f"gradient, Adam step finite; children {children_s:.1f} s",
          flush=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"# phase 41: {rec['phase_s']:.1f} s", flush=True)
    return rec


def slice_7c_launches(rec, kernel):
    """``kernel``'s launches in phase 41's renders and value+grads."""
    if kernel in ("tile_sweep", "grid_gather"):
        out = {f"41a NCCL large3d pool, {len(rec['nccl']['ranks'])} rank(s)":
               rec["nccl"]["launches"][kernel]}
        for r in rec["gloo_shared_card"]["ranks"]:
            out[f"41b gloo rank {r['rank']} large3d pool"] = r["launches"][
                kernel]
        if kernel == "grid_gather":
            for r in rec["gloo_shared_card"]["ranks"]:
                out[f"41b gloo rank {r['rank']} 64^3 value+grad forward"] = \
                    r["value_grad"]["forward"][kernel]
        return out
    return {f"41b gloo rank {r['rank']} 64^3 value+grad backward":
            r["value_grad"]["backward_grid_trilinear_bwd"]
            for r in rec["gloo_shared_card"]["ranks"]}


# ---- phase 42: the remaining helpers and the transport mode (slice 7d) ------

# phase 42's device, warp lanes and BSDF interactions (a CPU rehearsal
# maps and shrinks them)
S42_DEVICE, S42_LANES, S42_BSDF_LANES = "cuda", 1 << 20, 1 << 16
EPS32 = float(np.finfo(np.float32).eps)


def synth_pbsdf(P=8, T=6, H=7):
    """A synthetic KAIST-format pBRDF (tests/test_measured.py's): M00 =
    (0.2 + 0.5 cos theta_h) wvl / 650, off-diagonals proportional."""
    phi_d = np.linspace(0, np.pi, P).astype(np.float32)[None, :]
    theta_d = np.linspace(0, np.pi / 2, T).astype(np.float32)[None, :]
    theta_h = np.linspace(0, np.pi / 2, H).astype(np.float32)[None, :]
    wvls = np.asarray([450, 500, 550, 600, 650], np.uint16)
    m = np.zeros((P, T, H, len(wvls), 4, 4), np.float32)
    m00 = (0.2 + 0.5 * np.cos(theta_h[0]))[None, None, :, None] \
        * (wvls.astype(np.float32) / 650.0)[None, None, None, :]
    for (i, j), f in (((0, 0), 1.0), ((1, 1), 0.3), ((2, 2), -0.2),
                      ((3, 3), 0.1), ((0, 1), 0.05), ((1, 0), 0.05)):
        m[..., i, j] = f * m00
    return {"theta_h": theta_h, "theta_d": theta_d, "phi_d": phi_d,
            "wvls": wvls, "M": m}


def ulps_over(got, want, cond=0.0):
    """The largest |got - want| / (eps (1 + |want| + cond)) (float64 on
    the host): the error in float32 ulps of an O(1) value, cond the
    output's condition number against a 1-ulp change of an
    intermediate. The same infinities are required."""
    got = got.detach().cpu().double()
    want = want.detach().cpu().double()
    fin = torch.isfinite(want)
    assert torch.equal(got[~fin], want[~fin])
    cond = torch.as_tensor(cond, dtype=torch.float64)
    err = (got - want).abs() / (EPS32 * (1.0 + want.abs() + cond))
    return float(torch.where(fin, err, 0.0).max())


def sphere_cond(d):
    """|cos| / sin of directions d (N, 3) for their x and y: near the
    pole sin = sqrt(1 - cos^2) magnifies an ulp of cos."""
    d = d.detach().cpu().double()
    c = d[:, 2].abs() / torch.clamp(torch.sqrt(torch.clamp(
        1.0 - d[:, 2] ** 2, min=0.0)), min=1e-7)
    return torch.stack([c, c, torch.zeros_like(c)], -1)


# phase 42's outputs that are Mueller matrices (their entries are
# relative to M00, so a row's atol scales with its largest entry)
S42_MUELLER = ("eval_mueller", "sample_mueller_weight")


def rows_shares(got, want, rtol=1e-5, atol=1e-6, loose=5e-3):
    """The fractions of rows of ``got`` beyond (rtol, atol) and beyond
    (loose, atol) of ``want``'s, under the plain atol and under atol
    scaled by the row's largest |entry| where it exceeds 1: {"plain":
    [tight, wide], "scaled": [...]}."""
    a = got.detach().cpu().double().reshape(got.shape[0], -1)
    b = want.detach().cpu().double().reshape(want.shape[0], -1)
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    err = (a - b).abs()
    out = {}
    for name, tol in (("plain", atol), ("scaled", atol * torch.clamp(
            b.abs().amax(-1, keepdim=True), min=1.0))):
        out[name] = [float((err > r * b.abs() + tol).any(-1).double().mean())
                     for r in (rtol, loose)]
    return out


def rows_budget(got, want, mueller, miss=0.01, flip=0.001):
    """rows_shares of the card's ``got`` against the CPU's ``want``;
    raises past ``miss`` or ``flip`` (tests/test_torch_measured.py's
    budget), a ``mueller`` output under the scaled atol, every other
    under the plain one."""
    out = rows_shares(got, want)
    tight, wide = out["scaled" if mueller else "plain"]
    assert tight <= miss and wide <= flip, (tight, wide)
    return out


def slice_7d_warps(dev, n):
    """42a-b: every warp slice 7d added (and its pdf), solve_quadratic and
    legendre_p on n seeded lanes, the card against the CPU. Returns
    {name: worst error in ulps}."""
    from eradiate_kernel_tpu_torch.core import math as m
    from eradiate_kernel_tpu_torch.core import warp

    rng = np.random.default_rng(42)
    s = torch.as_tensor(rng.random((n, 2), dtype=np.float32))
    v = torch.as_tensor(rng.uniform(0.1, 2.0, (4, n)).astype(np.float32))

    def both(fn, *args):
        """fn on the card and on the CPU, the card's result on the host."""
        got = fn(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
        got = (tuple(g.cpu() for g in got) if isinstance(got, tuple)
               else got.cpu())
        return got, fn(*args)

    out = {}
    for name in ("square_to_uniform_disk", "square_to_tent",
                 "square_to_std_normal"):
        out[name] = ulps_over(*both(getattr(warp, name), s))
    out["interval_to_tent"] = ulps_over(*both(warp.interval_to_tent,
                                              s[:, 0]))
    out["interval_to_nonuniform_tent"] = ulps_over(*both(
        warp.interval_to_nonuniform_tent, -1.0, 0.3, 2.0, s[:, 0]))
    out["uniform_disk_to_square_concentric"] = ulps_over(*both(
        warp.uniform_disk_to_square_concentric,
        warp.square_to_uniform_disk_concentric(s)))
    for name, pts in (
            ("square_to_uniform_disk_pdf",
             1.2 * warp.square_to_uniform_disk(s)),
            ("square_to_uniform_triangle_pdf", 1.2 * s - 0.1),
            ("square_to_uniform_hemisphere_pdf",
             warp.square_to_uniform_sphere(s)),
            ("square_to_tent_pdf", 1.1 * warp.square_to_tent(s)),
            ("square_to_std_normal_pdf", warp.square_to_std_normal(s))):
        out[name] = ulps_over(*both(getattr(warp, name), pts))
    out["square_to_bilinear_pdf"] = ulps_over(*both(
        warp.square_to_bilinear_pdf, *v, s))
    for kind, pars in (("beckmann", (0.1, 0.5, 1.0)),
                       ("von_mises_fisher", (0.5, 10.0, 100.0))):
        fn = getattr(warp, f"square_to_{kind}")
        pdf = getattr(warp, f"square_to_{kind}_pdf")
        for par in pars:
            got, want = both(fn, s, par)
            out[f"square_to_{kind} {par}"] = ulps_over(got, want,
                                                       sphere_cond(want))
            out[f"square_to_{kind}_pdf {par}"] = ulps_over(*both(
                pdf, want, par))
    abc = torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32))
    abc[0, : n // 10] = 0.0  # a tenth linear
    got, want = both(m.solve_quadratic, *abc)
    assert torch.equal(got[0], want[0]), "solve_quadratic validity"
    ok = want[0]
    out["solve_quadratic"] = max(ulps_over(g[ok], w[ok])
                                 for g, w in zip(got[1:], want[1:]))
    c = torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32))
    out["legendre_p 0..8"] = max(ulps_over(*both(m.legendre_p, k, c))
                                 for k in range(9))
    return out


def s42_interactions(n, seed, dev):
    """A SurfaceInteraction of n seeded lanes (random shading frames and
    tangents, incident directions in both hemispheres, a fifth along the
    normal) on ``dev``, and seeded (wo, s1, s2)."""
    from eradiate_kernel_tpu_torch.core.frame import Frame
    from eradiate_kernel_tpu_torch.render.records import SurfaceInteraction

    rng = np.random.default_rng(seed)

    def unit():
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    nrm, wi = unit(), unit()
    wi[: n // 5] = [0.0, 0.0, 1.0]
    dp_du = np.cross(nrm, unit()).astype(np.float32)
    arrays = dict(t=np.ones(n, np.float32), p=np.zeros((n, 3), np.float32),
                  n=nrm, uv=rng.random((n, 2), dtype=np.float32),
                  prim_uv=np.zeros((n, 2), np.float32), dp_du=dp_du,
                  dp_dv=np.zeros((n, 3), np.float32), wi=wi,
                  time=np.zeros(n, np.float32),
                  prim_index=np.zeros(n, np.int32),
                  shape_index=np.zeros(n, np.int32),
                  wavelengths=np.zeros((n, 0), np.float32))
    t = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    si = SurfaceInteraction(sh_frame=Frame.from_normal(t["n"]), **t)
    draws = (unit(), rng.random(n, dtype=np.float32),
             rng.random((n, 2), dtype=np.float32))
    return si, [torch.as_tensor(a, device=dev) for a in draws]


S42_KINDS = {
    "conductor": {"type": "conductor", "material": "au"},
    "dielectric": {"type": "dielectric", "int_ior": 1.5},
    "roughconductor": {"type": "roughconductor", "material": "cu",
                       "alpha_u": 0.2, "alpha_v": 0.4},
    "roughdielectric": {"type": "roughdielectric", "alpha": 0.3,
                        "distribution": "beckmann", "int_ior": 1.5},
    "pplastic": {"type": "twosided", "bsdf": {
        "type": "pplastic", "alpha": 0.25,
        "diffuse_reflectance": [0.3, 0.4, 0.5]}},
    "measured_polarized": {"type": "measured_polarized",
                           "fields": synth_pbsdf(), "alpha_sample": 0.35},
}


def s42_kind_outputs(scene, kind, mode, si, draws, given=None):
    """{output: tensor} of kind's entries in ``mode``; the Mueller weight
    of ``given`` (BSDFSample, weight) if given, else of the sample's (a
    transmission's weight near grazing magnifies the ulps of its wo)."""
    from eradiate_kernel_tpu_torch import bsdfs

    mod = bsdfs.REGISTRY[kind]
    n = si.t.shape[0]
    dev = si.t.device
    k = scene.config.bsdf_kinds.index(kind)
    slot = int(scene.bsdf_slot[int(torch.nonzero(
        scene.bsdf_kind == k)[0, 0])])
    sl = torch.full((n,), slot, dtype=torch.int32, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    wo, s1, s2 = draws
    params = scene.bsdfs[kind]
    bs, w = mod.sample(scene, params, sl, si, s1, s2, act, mode)
    v, p = mod.eval_pdf(scene, params, sl, si, wo, act, mode)
    out = {"sample wo": bs.wo, "sample pdf": bs.pdf, "sample weight": w,
           "eval value": v, "eval pdf": p,
           "sampled_type": bs.sampled_type}
    if hasattr(mod, "eval_mueller"):
        out["eval_mueller"] = mod.eval_mueller(scene, params, sl, si, wo,
                                               act, mode)
    if hasattr(mod, "sample_mueller_weight"):
        if given is not None:
            bs, w = given
        out["sample_mueller_weight"] = mod.sample_mueller_weight(
            scene, params, sl, si, bs, w, act, mode)
        out["_given"] = bs, w
    return out


def s42_volume_gradient(dev, n):
    """42d: volume_eval_gradient at n seeded points of the 64^3 atmosphere
    (262,144 voxels: the packed lookup, whose positions gradient reads the
    8-corner rows through the grid_gather kernel's gather entry), lanes
    alternating between its sigma_t grid and its albedo constvolume,
    through the kernel and through the plain gather (gather.use_plain) on
    the same device: bit for bit, the constvolume's lanes zero, and (on
    the card) grid_gather launches = 1 + the output's channels (the
    lookup, a positions backward for each) through the kernel and none
    through the plain version. Raises on a mismatch."""
    from eradiate_kernel_tpu_torch.ops import gather
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.textures import volumes
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    scene = load_dict(atmosphere(2, 2, 1, 2, grid_res=(64, 64, 64)),
                      device=dev)
    assert scene.vol_packed is not None
    rng = np.random.default_rng(42)
    p = torch.as_tensor(rng.uniform([-22, -22, -0.2], [23, 23, 1.2], (n, 3))
                        .astype(np.float32), device=dev)
    vidx = (torch.arange(n, device=dev) % 2).to(torch.int32)
    before = gather.launches["grid_gather"]
    got = volumes.volume_eval_gradient(scene, vidx, p)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = gather.launches["grid_gather"] - before
    with gather.use_plain():
        want = volumes.volume_eval_gradient(scene, vidx, p)
    assert gather.launches["grid_gather"] - before == launches
    if dev.type == "cuda":
        assert launches == 1 + got.shape[-2], launches
    assert got.shape == (n, got.shape[-2], 3)
    assert bool(torch.isfinite(got).all()) and bool(got[::2].abs().max() > 0)
    assert not bool(got[1::2].any())
    err = float((got - want).abs().max())
    assert torch.equal(got, want), err
    print(f"# 42d volume_eval_gradient at {n} points of the 64^3 "
          f"atmosphere, grid_gather kernel against the plain gather: bit "
          f"for bit (max abs err {err}), {launches} grid_gather launches",
          flush=True)
    return {"points": n, "launches": launches, "max_abs_err": err,
            "max_abs_gradient": float(got.abs().max())}


def slice_7d_phases():
    """Phase 42 (slice 7d; no new kernel): (a) every warp slice 7d added and
    its pdf on 2^20 seeded lanes, the card against the CPU within 8
    float32 ulps of an O(1) value (x and y of a direction near the pole
    scaled by |cos| / sin, which magnifies an ulp of cos); (b)
    solve_quadratic (validity exact) and legendre_p (n <= 8, 64 ulps) on
    2^20 lanes; (c) both transport modes of the six mode-dependent BSDFs
    on 65,536 seeded interactions: sample, eval_pdf and the Mueller entry
    (a Mueller weight of the CPU's sample on both), the card against the
    CPU within tests/test_torch_measured.py's budget (rtol 1e-5, atol
    1e-6, a Mueller output's of the row's largest entry, but for 1 % of
    the rows, those within 5e-3 but for 0.1 %), sampled lobes equal but
    for 0.1 %, IMPORTANCE moving the card's results where it moves the
    CPU's, and a Mueller output that the mode moves on over 1 % of the
    CPU's rows failing the scaled atol in the wrong mode; (d) volume_eval_gradient on the 64^3 atmosphere, the
    grid_gather kernel against the plain gather bit for bit
    (s42_volume_gradient). Raises on a mismatch. Returns the records."""
    from eradiate_kernel_tpu_torch.bsdfs import common
    from eradiate_kernel_tpu_torch.scene import load_dict

    t_phase = time.perf_counter()
    dev = torch.device(S42_DEVICE)
    rec = {}

    # ---- 42a-b. warps, solve_quadratic, legendre_p --------------------------
    phase_clock("42a")
    t0 = time.perf_counter()
    ulps = slice_7d_warps(dev, S42_LANES)
    worst = max(ulps, key=ulps.get)
    rec["warps_ulps"] = ulps
    assert ulps["legendre_p 0..8"] <= 64.0 and all(
        v <= 8.0 for k, v in ulps.items() if k != "legendre_p 0..8"), ulps
    rec["warps_s"] = time.perf_counter() - t0
    print(f"# 42a-b {len(ulps)} warps, pdfs, solve_quadratic and "
          f"legendre_p on {S42_LANES} lanes, card against CPU: within "
          f"{max(v for k, v in ulps.items() if k != 'legendre_p 0..8'):.2f}"
          f" of the 8-ulp tolerance's ulps (legendre_p "
          f"{ulps['legendre_p 0..8']:.2f} of 64; worst {worst}); "
          f"{rec['warps_s']:.2f} s", flush=True)

    # ---- 42c. the six mode-dependent BSDFs in both modes --------------------
    phase_clock("42c")
    t0 = time.perf_counter()
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"width": 2,
                                                    "height": 2}}}
    for i, (kind, bsdf) in enumerate(S42_KINDS.items()):
        d[f"s_{kind}"] = {"type": "rectangle", "bsdf": bsdf, "to_world": {
            "type": "translate", "value": [0.0, 0.0, float(i)]}}
    scenes = {"card": load_dict(d, device=dev),
              "cpu": load_dict(d, device="cpu")}
    inputs = {where: s42_interactions(S42_BSDF_LANES, 42, dv)
              for where, dv in (("card", dev), ("cpu", "cpu"))}
    rec["bsdfs"] = {}
    worst = worst_plain = (0.0, 0.0)
    for kind in S42_KINDS:
        outs = {}
        for mode in (common.RADIANCE, common.IMPORTANCE):
            cpu = s42_kind_outputs(scenes["cpu"], kind, mode,
                                   *inputs["cpu"])
            given = cpu.pop("_given", None)
            if given is not None:  # the CPU's sample, on the card
                bs, w = given
                given = (common.BSDFSample(
                    **{f: getattr(bs, f).to(dev) for f in (
                        "wo", "pdf", "eta", "sampled_type")}), w.to(dev))
            card = s42_kind_outputs(scenes["card"], kind, mode,
                                    *inputs["card"], given=given)
            card.pop("_given", None)
            for what in card:
                if what == "sampled_type":
                    flips = float((card[what].cpu() != cpu[what])
                                  .double().mean())
                    assert flips <= 0.001, (kind, mode, flips)
                    continue
                mueller = what in S42_MUELLER
                r = rows_budget(card[what], cpu[what], mueller)
                rec["bsdfs"][f"{kind} {mode} {what}"] = r
                worst = max(worst, tuple(r["scaled" if mueller
                                           else "plain"]))
                if mueller:
                    worst_plain = max(worst_plain, tuple(r["plain"]))
            outs[mode] = card, cpu
        # IMPORTANCE moves the card's rows where it moves the CPU's
        (rc, rp), (ic, ip) = outs[common.RADIANCE], outs[common.IMPORTANCE]
        for what in rc:
            if what == "sampled_type":
                continue
            moved = [~torch.isclose(a.cpu().double().reshape(len(a), -1),
                                    b.cpu().double().reshape(len(b), -1),
                                    rtol=1e-5, atol=1e-6).all(-1)
                     for a, b in ((rc[what], ic[what]),
                                  (rp[what], ip[what]))]
            assert float((moved[0] != moved[1]).double().mean()) <= 0.001, \
                (kind, what)
            moved_cpu = float(moved[1].double().mean())
            if what in S42_MUELLER and moved_cpu > 0.01:
                # the scaled atol still fails the card's RADIANCE held to
                # the CPU's IMPORTANCE (a wrong mode)
                swapped = rows_shares(rc[what], ip[what])["scaled"]
                assert swapped[0] > 0.01, (kind, what, swapped)
                rec["bsdfs"][f"{kind} swapped modes {what}"] = {
                    "cpu_moved": moved_cpu, "scaled": swapped}
    rec["bsdfs_s"] = time.perf_counter() - t0
    print(f"# 42c six mode-dependent BSDFs x 2 modes on {S42_BSDF_LANES} "
          f"interactions, card against CPU: every output within rtol "
          f"1e-5, atol 1e-6 (a Mueller output's of the row's largest "
          f"entry, if over 1) but for {worst[0]:.4f} of the rows (budget "
          f"0.01), within 5e-3 but for {worst[1]:.4f} (budget 0.001); the "
          f"Mueller outputs under the plain atol {worst_plain[0]:.4f} and "
          f"{worst_plain[1]:.4f}; IMPORTANCE moves the same rows, and a "
          f"Mueller output in the wrong mode fails the scaled atol; "
          f"{rec['bsdfs_s']:.2f} s", flush=True)

    # ---- 42d. volume_eval_gradient through the packed lookup ----------------
    phase_clock("42d")
    t0 = time.perf_counter()
    rec["volume_eval_gradient"] = s42_volume_gradient(dev, S42_BSDF_LANES)
    rec["volume_eval_gradient"]["s"] = time.perf_counter() - t0
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"# phase 42: {rec['phase_s']:.1f} s", flush=True)
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--s41-child"]:
        return s41_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    from eradiate_kernel_tpu_torch import integrators
    from eradiate_kernel_tpu_torch.core.ray import Ray
    from eradiate_kernel_tpu_torch.ops import (_build, accel, bvh, gather,
                                               intersect)
    from eradiate_kernel_tpu_torch.ops.accel import pack_tiles
    from eradiate_kernel_tpu_torch.scene import build, load_dict
    from eradiate_kernel_tpu_torch.textures import volumes
    from eradiate_kernel_tpu_torch.utils import bitmap
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    dev = torch.device("cuda")
    # the reference pins float32 matmuls to full precision; so does the port
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    print(f"# device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build ------------------------------------------------------------
    phase_clock("1")
    t0 = time.perf_counter()
    secs = _build.build_kernels(verbose=True)
    assert set(secs) == {"tile_sweep", "tile_bvh", "tile_bvh8",
                         "grid_gather"}, secs
    print(f"# build: {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())}"
          f" (in parallel, {time.perf_counter() - t0:.2f} s in all)",
          flush=True)
    # the leaves' reciprocal (__frcp_rn), staging (LDGSTS), 128-bit shared
    # or global loads, and the barriers a kernel build takes (BAR: block,
    # WARPSYNC: warp)
    for name in ("tile_sweep", "tile_bvh", "tile_bvh8", "grid_gather"):
        for fn, ops in (sass_counts(name) or {name: "no cuobjdump"}).items():
            print(f"# SASS {fn}: {ops}", flush=True)
    # the host libraries, g++ into the same build directory: the tile and
    # BVH builders (None: no g++, which phase 40c refuses) and the OpenEXR
    # bridge (None: no libOpenEXR)
    t0 = time.perf_counter()
    host = {"tile_builder": accel._builder(), "bvh_builder": bvh._builder(),
            "exr_bridge": bitmap._load_bridge()}
    print(f"# build: g++ {', '.join(k for k, v in host.items() if v)} in "
          f"{time.perf_counter() - t0:.2f} s; missing: "
          f"{[k for k, v in host.items() if v is None] or 'none'}",
          flush=True)

    # ---- 2. tile sweep vs plain on the bench terrain --------------------------
    phase_clock("2")
    V, F = terrain(256)
    tiles_np = pack_tiles(V, None, F, np.zeros(len(F), np.int32))
    tiles = {k: torch.as_tensor(v, device=dev) for k, v in tiles_np.items()}
    # the tables a scene's Geometry builds once at load
    tiles["root"], tiles["rows"] = intersect.sweep_tables(tiles)
    print(f"# terrain: {len(F)} triangles, {len(tiles_np['lo'])} tiles",
          flush=True)
    n_rays = 1 << 20
    terrain_rays = {}
    loads = {}
    max_err = 0.0
    for kind in ("primary", "incoherent"):
        o, d = make_rays(n_rays, kind)
        ray = Ray.make(torch.as_tensor(o, device=dev),
                       torch.as_tensor(d, device=dev))
        terrain_rays[kind] = ray
        args, _unsort, _n = intersect.prepare_sweep(tiles, ray)
        out = intersect.sweep(*args)
        ref = intersect._sweep_plain(*args)
        torch.cuda.synchronize()
        t_k, uv_k, prim_k, shape_k, vis_k = out
        t_p, uv_p, prim_p, shape_p, vis_p = ref
        miss_k, miss_p = torch.isinf(t_k), torch.isinf(t_p)
        assert torch.equal(miss_k, miss_p), f"{kind}: miss sets differ"
        hit = ~miss_k
        err = float((t_k[hit] - t_p[hit]).abs().max()) if hit.any() else 0.0
        max_err = max(max_err, err)
        # bit-exact: both evaluate the same float32 expressions in the same
        # order with every product and sum rounded (-fmad=false)
        assert torch.equal(t_k, t_p), f"{kind}: t differs (max {err})"
        assert torch.equal(uv_k, uv_p), f"{kind}: uv differs"
        assert torch.equal(prim_k, prim_p) and torch.equal(shape_k, shape_p), \
            f"{kind}: prim/shape differ"
        assert torch.equal(vis_k, vis_p), f"{kind}: visit counts differ"
        ms = cuda_ms(lambda: intersect.sweep(*args), reps=10)
        plain_ms = cuda_ms(lambda: intersect._sweep_plain(*args), reps=1)
        full_ms = cuda_ms(lambda: intersect.intersect_tiles(tiles, ray),
                          reps=5)
        bound_ms, bound_by, visits = sweep_bound(args, vis_k)
        loads[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, visits=visits,
                           hit_frac=float(hit.float().mean()),
                           intersect_tiles_ms=full_ms)
        print(f"# sweep {kind}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.3f} ms ({bound_by}), tiles visited "
              f"{visits} ({visits / args[2].shape[0]:.1f}/block), hits "
              f"{loads[kind]['hit_frac']:.3f}, intersect_tiles "
              f"{full_ms:.3f} ms ({n_rays / full_ms / 1e3:.1f} Mrays/s)",
              flush=True)

    # ---- 3. full-width terrain render through the port's entry points -------
    phase_clock("3")
    scene = load_dict(terrain_scene(V, F, 256, 256, 16, 6))
    integrators.render(scene, seed=0, spp=1)  # warm-up (allocator)
    img, render_s, launches, bounces, queries, traced = counted_render(
        scene)
    check_render("render 256x256 spp16 max_depth 6", scene, img, render_s,
                 launches, bounces, queries, traced, "tile_sweep",
                 (0.005, 0.5))
    sweep_launches = launches["tile_sweep"]
    terrain_img = img  # phase 29's films from mesh files equal it
    REF_FILMS.update({"terrain image": img, "terrain queries": queries})

    # ---- 4. whole path: kernel vs plain sweep --------------------------------
    phase_clock("4")
    # max_depth 3 (6 until phase 40 was added): the plain sweep's time
    small = load_dict(terrain_scene(V, F, 64, 64, 4, 3))
    film_k = integrators.render(small, seed=3, develop_film=False)
    with intersect.use_plain():
        film_p = integrators.render(small, seed=3, develop_film=False)
    flips = films_equivalent(film_p.cpu().numpy(), film_k.cpu().numpy(),
                             max_flips=2)
    print(f"# whole path 64x64 spp4 max_depth 3: kernel vs plain films agree "
          f"({flips} pixels over tolerance, budget 2)", flush=True)

    # ---- 5. BVH kernels vs plain: terrain(256) and the forest ---------------
    phase_clock("5")
    t0 = time.perf_counter()
    nbox, nmeta, depth = bvh.build_tile_bvh(tiles_np["lo"], tiles_np["hi"])
    cbox, cmeta = bvh.collapse_to_bvh8(nbox, nmeta)
    print(f"# terrain BVH: depth {depth}, {len(nmeta)} binary nodes, "
          f"{len(cbox)} 8-wide nodes, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for k, v in dict(nbox=nbox, nmeta=nmeta, cbox=cbox, cmeta=cmeta).items():
        tiles[k] = torch.as_tensor(v, device=dev)

    bvh_build_s = [0.0]
    build_tile_bvh = build.build_tile_bvh

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = build_tile_bvh(*a, **kw)
        bvh_build_s[0] += time.perf_counter() - t0
        return out

    build.build_tile_bvh = timed_build
    try:
        t0 = time.perf_counter()
        forest = load_dict(forest_scene(256, 256, 16, 6))
        load_s = time.perf_counter() - t0
    finally:
        build.build_tile_bvh = build_tile_bvh
    geo = forest.geo
    n_leaves = (geo.bvh_meta[:, 2] >= 0).sum().item()
    print(f"# forest: {geo.n_instances} instances x {geo.ig_faces.shape[0]} "
          f"shared triangles (= {geo.n_instances * geo.ig_faces.shape[0]} "
          f"effective), {geo.tiles_v0.shape[0]} group tiles, {n_leaves} BVH "
          f"leaves, {geo.bvh8_box.shape[0]} 8-wide nodes; load_dict "
          f"{load_s:.2f} s of which the binary BVH build "
          f"{bvh_build_s[0]:.2f} s", flush=True)
    forest_tiles = geo.tiles()
    n_forest = 1 << 19
    o, d = make_rays(n_forest, "primary")
    o = o * np.float32([8, 8, 1])  # bench_forest's wider camera footprint
    forest_ray = Ray.make(torch.as_tensor(o, device=dev),
                          torch.as_tensor(d, device=dev))

    bvh_loads = {}
    for name in ("tile_bvh", "tile_bvh8"):
        for load, (tl, ray, n) in {
                "forest": (forest_tiles, forest_ray, n_forest),
                "terrain primary": (tiles, terrain_rays["primary"], n_rays),
                "terrain incoherent": (tiles, terrain_rays["incoherent"],
                                       n_rays)}.items():
            rec = check_bvh_load(name, tl, ray, n)
            bvh_loads[(name, load)] = rec
            print(f"# {name} {load}: kernel {rec['ms']:.3f} ms, plain "
                  f"{rec['plain_ms']:.1f} ms (bit-equal), bound "
                  f"{rec['bound_ms']:.3f} ms "
                  f"({rec['bound_by']}), inner nodes {rec['inner_visits']}, "
                  f"leaves {rec['leaf_visits']}, deepest stack "
                  f"{rec['deepest_stack']}, hits {rec['hit_frac']:.3f}, "
                  f"intersect {rec['intersect_ms']:.3f} ms "
                  f"({rec['mrays_per_s']:.1f} Mrays/s)", flush=True)
    for name in ("tile_bvh", "tile_bvh8"):
        for kind in ("primary", "incoherent"):
            ratio = (loads[kind]["intersect_tiles_ms"]
                     / bvh_loads[(name, f"terrain {kind}")]["intersect_ms"])
            print(f"# terrain {kind}: {name} over tiles {ratio:.3f} "
                  "(Mrays/s ratio, full queries)", flush=True)

    # ---- 6. full-width forest renders through each BVH kernel ---------------
    phase_clock("6")
    integrators.render(forest, seed=0, spp=1)  # warm-up (allocator)
    forest_runs = {}
    for name, wide in (("tile_bvh", "0"), ("tile_bvh8", "1")):
        with env(ERT_BVH_WIDE=wide):
            img, secs_r, launches, bounces, queries, traced = counted_render(
                forest)
        label = f"forest render 256x256 spp16 max_depth 6 ({name})"
        mean = check_render(label, forest, img, secs_r, launches, bounces,
                            queries, traced, name, (0.005, 0.5))
        cfg = forest.config
        n_samples = cfg.film_height * cfg.film_width * cfg.spp
        forest_runs[name] = dict(render_ms=secs_r * 1e3,
                                 msamples_per_s=n_samples / secs_r / 1e6,
                                 launches=launches[name], queries=queries,
                                 image_mean=mean)
        # the render's own queries (the bounces' rays): its kernel stage
        # with each launch synchronised, ms a launch beside the bound
        with env(ERT_BVH_WIDE=wide):
            stage = render_kernel_stage(forest, name)
        forest_runs[name]["kernel"] = stage
        print(f"# forest render ({name}) kernel stage "
              f"{stage['stage_ms']:.1f} ms over {stage['launches']} "
              f"launches, {stage['ms_per_launch']:.3f} ms a launch, bound "
              f"{stage['bound_ms_per_launch']:.3f} ms a launch "
              f"({stage['bound_by']}), inner nodes {stage['inner_visits']}, "
              f"leaves {stage['leaf_visits']}", flush=True)

    # ---- 7. whole path: each BVH kernel vs its plain version ----------------
    phase_clock("7")
    # max_depth 2 (phase 6 renders 6): the time limit (the plain walks)
    small_forest = load_dict(forest_scene(64, 64, 4, 2))
    films = {}
    for name, wide in (("tile_bvh", "0"), ("tile_bvh8", "1")):
        with env(ERT_BVH_WIDE=wide):
            films[name] = integrators.render(small_forest, seed=3,
                                             develop_film=False)
            with intersect.use_plain():
                plain = integrators.render(small_forest, seed=3,
                                           develop_film=False)
        flips = films_equivalent(plain.cpu().numpy(),
                                 films[name].cpu().numpy(), max_flips=2)
        print(f"# whole path forest 64x64 spp4: {name} kernel vs plain films "
              f"agree ({flips} pixels over tolerance, budget 2)", flush=True)
    flips = films_equivalent(films["tile_bvh"].cpu().numpy(),
                             films["tile_bvh8"].cpu().numpy(), max_flips=2)
    print(f"# whole path forest 64x64 spp4: tile_bvh vs tile_bvh8 films "
          f"agree ({flips} pixels over tolerance, budget 2)", flush=True)

    # ---- 8. grid gather vs plain: the probe's shape and the 64^3 table -------
    phase_clock("8")
    gen = torch.Generator().manual_seed(0)
    probe_tab = torch.rand(4096, 1, generator=gen).to(dev)
    probe_idx = torch.randint(0, 4096, (1024,), generator=gen,
                              dtype=torch.int32).to(dev)
    grid64 = torch.rand(1, 64, 64, 64, 1, generator=gen).to(dev)
    packed = volumes.packed_corners(grid64)
    pl = torch.rand(1 << 15, 3, generator=gen).to(dev)
    slot0 = torch.zeros(1 << 15, dtype=torch.int32, device=dev)
    corner_idx = volumes._corner0((1, 64, 64, 64), slot0, pl)[0]
    gather_loads = {"probe": (probe_tab, probe_idx),
                    "packed 64^3": (packed, corner_idx)}
    for load, (table, idx) in gather_loads.items():
        rec = gather_loads[load] = gather_load(table, idx)
        rec["host_us"] = gather_host_us(table, idx)
        print(f"# grid_gather {load} ({rec['rows']} rows of "
              f"{rec['row_floats']} f32, {rec['lanes']} lanes): kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
              f"(bit-equal), index_select {rec['library_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); device us a "
              f"call {rec['device_us']}; host us a call (median of 5 rounds "
              f"of 2,000 calls): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in rec["host_us"].items()),
              flush=True)
    trilinear = trilinear_load(grid64, packed, slot0, pl)
    print(f"# grid_trilinear packed 64^3 ({trilinear['lanes']} lanes): fused "
          f"lookup {trilinear['ms']:.4f} ms, plain chain "
          f"{trilinear['plain_ms']:.4f} ms (bit-equal), grid_sample "
          f"{trilinear['library_ms']:.4f} ms (max abs err "
          f"{trilinear['library_max_abs_err']:.2e}), bound "
          f"{trilinear['bound_ms']:.5f} ms ({trilinear['bound_by']}); device "
          f"us a call {trilinear['device_us']}",
          flush=True)

    # ---- 9-10. atmosphere renders on the regenerating lane pool --------------
    phase_clock("9-10")
    lanes = 1 << 15

    def bench_atmosphere(*args, **kw):
        """bench.py's load: the atmosphere with residual NEE, set as the
        bench sets it."""
        d = atmosphere(*args, **kw)
        d["integrator"]["nee_transmittance"] = "residual"
        return load_dict(d)

    # the flagship at bench.py's spp 64; the 64^3 grid at spp 4 (bench.py:
    # 64; cut from 16 when phases 15-20 were added): the time limit
    flagship = bench_atmosphere(256, 256, 64, 12, grid_res=64)
    integrators.render_wavefront_regen(flagship, lanes, 0, 1)  # warm-up
    film, atmo_s, launches, counts = counted_pool(flagship, lanes)
    atmo = {"flagship": check_atmosphere(
        "atmosphere 256x256 spp64 max_depth 12 grid 64", flagship, film,
        atmo_s, launches, counts)}
    REF_FILMS["flagship film"] = film  # phase 35's volpathmis is held to it
    assert launches["grid_gather"] == 0  # the einsum path: 1,024 voxels
    large = bench_atmosphere(256, 256, 4, 12, grid_res=(64, 64, 64))
    assert large.vol_packed is not None
    with walk_steps() as steps:
        film, secs_l, launches, counts = counted_pool(large, lanes)
    large_film = film  # phase 33's ablations hold their films to it
    REF_FILMS["large3d film"] = film
    atmo["large3d"] = check_atmosphere(
        "atmosphere 256x256 spp4 max_depth 12 grid 64^3", large, film,
        secs_l, launches, counts)
    atmo["large3d"]["walk_steps"] = steps["n"]
    assert launches["grid_gather"] > 0

    # the fused query at the atmosphere's shape: the one-tile cube, a pool
    # of 32,768 rays from inside the slab in random directions; then an
    # 8-tile terrain(23) (968 triangles) under the bench camera's primary
    # rays and incoherent rays, 32,768 each
    o = torch.rand(lanes, 3, generator=gen) * torch.tensor([30.0, 30.0, 1.0])
    o = (o - torch.tensor([15.0, 15.0, 0.0])).to(dev)
    d = torch.nn.functional.normalize(torch.randn(lanes, 3, generator=gen),
                                      dim=-1).to(dev)
    small_loads = {"atmosphere cube": (flagship.geo.tiles(), Ray.make(o, d))}
    V8, F8 = terrain(23)
    tiles8 = {k: torch.as_tensor(v, device=dev) for k, v in
              pack_tiles(V8, None, F8, np.zeros(len(F8), np.int32)).items()}
    assert tiles8["lo"].shape[0] == 8
    tiles8["root"], tiles8["rows"] = intersect.sweep_tables(tiles8)
    for kind in ("primary", "incoherent"):
        o8, d8 = make_rays(lanes, kind, seed=5)
        small_loads[f"terrain(23) {kind}"] = (tiles8, Ray.make(
            torch.as_tensor(o8, device=dev), torch.as_tensor(d8, device=dev)))
    for load, (tl, ray) in small_loads.items():
        rec = small_loads[load] = small_query_load(tl, ray)
        print(f"# fused sweep {load} ({rec['tiles']} tiles, {rec['rays']} "
              f"rays): intersect_tiles (one launch) {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.3f} ms (bit-equal, visits {rec['visits']}),"
              f" bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}); eager "
              f"sorted pipeline {rec['eager_pipeline_ms']:.3f} ms, its kernel "
              f"{rec['eager_kernel_ms']:.4f} ms (visits "
              f"{rec['eager_visits']}); hits {rec['hit_frac']:.3f}; device "
              f"us a call {rec['device_us']}",
              flush=True)
    # where the sort starts to pay (intersect.SWEEP_FUSED_MAX_RAY_TILES):
    # terrain(23), (33), (46) (8, 16 and 32 tiles) under primary rays (the
    # path tracer's first bounce) and incoherent ones, 2^15 (the lane
    # pool's size) and 2^20 (a 256x256 spp16 pass) of each, the fused query
    # beside the sorted pipeline
    crossover = {}
    for n_grid in (23, 33, 46):
        Vc, Fc = terrain(n_grid)
        tc = {k: torch.as_tensor(v, device=dev) for k, v in
              pack_tiles(Vc, None, Fc, np.zeros(len(Fc), np.int32)).items()}
        tc["root"], tc["rows"] = intersect.sweep_tables(tc)
        for kind in ("primary", "incoherent"):
            for log_n in (15, 20):
                oc, dc = make_rays(1 << log_n, kind, seed=6)
                rec = crossover_load(tc, Ray.make(
                    torch.as_tensor(oc, device=dev),
                    torch.as_tensor(dc, device=dev)))
                crossover[f"{rec['tiles']} tiles {kind} 2^{log_n}"] = rec
                print(f"# fused vs sorted, terrain({n_grid}) {rec['tiles']} "
                      f"tiles, 2^{log_n} {kind} rays: fused "
                      f"{rec['fused_ms']:.3f} ms (visits "
                      f"{rec['fused_visits']}), sorted {rec['sorted_ms']:.3f}"
                      f" ms (visits {rec['sorted_visits']}), ratio "
                      f"{rec['fused_over_sorted']:.3f}", flush=True)

    # ---- 11. whole path on the 64^3 atmosphere: kernels vs plain -------------
    phase_clock("11")
    # max_depth 6 (12 until phase 39 was added): the plain legs' time
    small_atmo = bench_atmosphere(64, 64, 4, 6, grid_res=(64, 64, 64))
    film_k, _ = integrators.render_wavefront_regen(small_atmo, lanes, 3, 4)
    for name, plain in (("grid_gather", gather.use_plain),
                        ("tile_sweep", intersect.use_plain)):
        with plain():
            film_p, _ = integrators.render_wavefront_regen(small_atmo, lanes,
                                                           3, 4)
        flips = films_equivalent(film_p.cpu().numpy(), film_k.cpu().numpy(),
                                 max_flips=2)
        print(f"# whole path 64^3 atmosphere 64x64 spp4 max_depth 6: {name} "
              f"kernel vs "
              f"plain films agree ({flips} pixels over tolerance, budget 2)",
              flush=True)

    # ---- 13. the trilinear lookup's backward vs plain on the 64^3 load -------
    phase_clock("13")
    gen13 = torch.Generator().manual_seed(13)
    grid64_c3 = torch.rand(1, 64, 64, 64, 3, generator=gen13).to(dev)
    # C = S37_BANDS: phase 37c's gridvolume_spectral takes the same backward
    grid64_cs = torch.rand(1, 64, 64, 64, S37_BANDS, generator=gen13).to(dev)
    bwd_loads = {}
    for g64 in (grid64, grid64_c3, grid64_cs):
        C = g64.shape[-1]
        ct = torch.randn(pl.shape[0], C, generator=gen13).to(dev)
        rec = bwd_loads[f"C={C}"] = trilinear_bwd_load(g64, slot0, pl, ct)
        # exact where no two lanes share a corner (32^3 lanes)
        pl_d = distinct_corner_lanes(64, dev, gen13)
        ct_d = torch.randn(pl_d.shape[0], C, generator=gen13).to(dev)
        slot_d = torch.zeros(pl_d.shape[0], dtype=torch.int32, device=dev)
        assert torch.equal(
            gather.grid_trilinear_bwd(ct_d, g64.shape, slot_d, pl_d),
            volumes.trilinear_backward_plain(ct_d, g64.shape, slot_d, pl_d))
        rec["shared_row_share"] = shared_row_share(g64.shape, slot0, pl,
                                                   bwd_warp_lanes(C))
        if C == 1:
            rec["host_us"] = bwd_host_us(ct, tuple(g64.shape), slot0, pl)
        print(f"# grid_trilinear_bwd 64^3 C={C} ({rec['lanes']} lanes): "
              f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
              f"(max abs err {rec['max_abs_err']:.2e}; bit-equal on "
              f"{pl_d.shape[0]} lanes with distinct corners), grid_sample "
              f"backward {rec['library_ms']:.4f} ms (max abs err "
              f"{rec['library_max_abs_err']:.2e}), bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); device us a "
              f"call {rec['device_us']}; lanes sharing a warp's corner row "
              f"{rec['shared_row_share']:.4f}"
              + ("; host us a call (median of 5 rounds of 2,000 calls): "
                 + ", ".join(f"{k} {v:.2f}" for k, v in rec[
                     "host_us"].items()) if C == 1 else ""), flush=True)

    # ---- 14. value+grad of the flagship and the 64^3 atmosphere ----------------
    phase_clock("14")
    # spp 2 (cut from 4; the primal phases take 16 and 4): the time limit
    grads = {}
    keys = ["volumes.gridvolume.grid", "volumes.constvolume.value",
            "spectra.baked.value"]
    # max_depth 6 (12 until phase 39 was added)
    flagship4 = bench_atmosphere(256, 256, 2, 6, grid_res=64)
    rec, params = value_grad(flagship4, lanes, keys, threefry=True)
    grads["flagship"] = check_value_grad(
        "atmosphere 256x256 spp2 max_depth 6 grid 64", flagship4, rec,
        params)
    assert rec["backward"]["launches"]["grid_trilinear_bwd"] == 0  # einsum
    large4 = bench_atmosphere(256, 256, 2, 6, grid_res=(64, 64, 64))
    with capture_bwd(BWD_LOADS.setdefault("large3d", {})):
        rec, params = value_grad(large4, lanes, keys)
    grads["large3d"] = check_value_grad(
        "atmosphere 256x256 spp2 max_depth 6 grid 64^3", large4, rec,
        params)
    assert rec["backward"]["launches"]["grid_trilinear_bwd"] > 0
    # the same value+grad at 64x64 through the kernels and through the
    # plain gather (lookup and backward) and the plain sweep
    small_vg = {}
    for name, plain in (("kernels", contextlib.nullcontext),
                        ("grid_gather plain", gather.use_plain),
                        ("tile_sweep plain", intersect.use_plain)):
        with plain():
            _rec, params = value_grad(small_atmo, lanes, keys,
                                      with_primal=False)
        small_vg[name] = {k: p.grad for k, p in params.items()}
    for name in ("grid_gather plain", "tile_sweep plain"):
        worst = 0.0
        for k, g in small_vg["kernels"].items():
            ref = small_vg[name][k]
            ok = torch.isfinite(ref)
            torch.testing.assert_close(g[ok], ref[ok], rtol=1e-5, atol=1e-7)
            assert torch.equal(ok, torch.isfinite(g)), k
            worst = max(worst, float((g[ok] - ref[ok]).abs().max()))
        print(f"# whole path 64^3 atmosphere 64x64 spp4 max_depth 6 "
              f"value+grad: kernels "
              f"vs {name} gradients agree (rtol 1e-5, atol 1e-7; max abs "
              f"err {worst:.2e})", flush=True)

    pools, gates, surface_vg = surface_phases(
        scene, forest, V, F, render_s, forest_runs, lanes, atmo)
    measure = measurement_phases(V, F, lanes, {
        "scan": render_s * 1e3, "pool": pools["terrain"]["render_ms"]})
    materials = materials_phases(V, F, lanes)
    s5c2 = slice_5c2_phases(V, F, scene, terrain_img, lanes)
    s6a = slice_6a_phases(lanes, large_film, atmo["large3d"])
    s7a = slice_7a_phases(V, F, lanes, large_film)
    s6b = slice_6b_phases(V, F, lanes, REF_FILMS)
    s6c1 = slice_6c1_phases(lanes, atmo["large3d"])
    s6c2 = slice_6c2_phases(V, F, lanes, s6c1)
    s6d = slice_6d_phases(V, F, lanes)
    bwd_adjoint = adjoint_bwd_loads()
    s6e = slice_6e_phases(V, F)
    s7b = slice_7b_phases(V, F)
    s7c = slice_7c_phases(large_film)
    s7d = slice_7d_phases()

    if "--profile" in sys.argv[1:]:
        profile_render(lambda: integrators.render(scene, seed=0), render_s,
                       "terrain")
        profile_render(lambda: integrators.render(forest, seed=0),
                       forest_runs["tile_bvh"]["render_ms"] / 1e3, "forest")
        # the profiler traces a 4-spp window of the same lane pool (262,144
        # samples, 8 refills of the pool)
        profile_render(
            lambda: integrators.render_wavefront_regen(flagship, lanes, 0,
                                                       64),
            atmo_s, "atmosphere",
            window=lambda: integrators.render_wavefront_regen(
                flagship, lanes, 0, 4))
        profile_render(
            lambda: integrators.render_wavefront_regen(large, lanes, 0, 4),
            secs_l, "large3d",
            window=lambda: integrators.render_wavefront_regen(
                large, lanes, 0, 2))

    # ---- 12. report -----------------------------------------------------------
    phase_clock("12")
    p = loads["primary"]
    kernels = [{
        "name": "tile_sweep", "route": "cuda",
        "source": "eradiate_kernel_tpu_torch/csrc/tile_sweep.cu",
        "replaces": "eradiate_kernel_tpu/ops/pallas_intersect.py:94",
        "launches": sweep_launches, "max_abs_err": max_err,
        "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"], "library_ms": None,
        "load": "2^20 primary rays on terrain(256)",
        "incoherent": loads["incoherent"],
        "atmosphere_cube": dict(small_loads["atmosphere cube"], launches={
            k: v["launches"]["tile_sweep"] for k, v in atmo.items()},
            load="fused query, 32,768 rays, 1 tile"),
        "launches_lane_pool": {
            "terrain render": pools["terrain"]["launches"]["tile_sweep"],
            "terrain value+grad forward": surface_vg["terrain"]["forward"][
                "launches"]["tile_sweep"],
            "terrain value+grad backward": surface_vg["terrain"][
                "backward"]["launches"]["tile_sweep"],
            "sky-lit atmosphere": atmo["sky"]["launches"]["tile_sweep"]},
        "launches_measurement": dict(
            {k: v["launches"]["tile_sweep"]
             for k, v in measure["atmosphere"].items()},
            **{"terrain gaussian pool": measure["gaussian"]["launches"][
                "tile_sweep"],
               "terrain gaussian value+grad forward": measure[
                   "gaussian_value_grad"]["forward"]["launches"][
                   "tile_sweep"],
               "terrain gaussian value+grad backward": measure[
                   "gaussian_value_grad"]["backward"]["launches"][
                   "tile_sweep"]}),
        "launches_materials": {
            "materials cornell box pool (fused)": materials["cornell"][
                "launches"]["tile_sweep"],
            "materials cornell box value+grad forward": materials[
                "cornell_value_grad"]["forward"]["launches"]["tile_sweep"],
            "materials cornell box value+grad backward": materials[
                "cornell_value_grad"]["backward"]["launches"]["tile_sweep"],
            "materials terrain scan (sorted)": materials["terrain"][
                "scan_launches"],
            "materials terrain pool (sorted)": materials["terrain"][
                "launches"]["tile_sweep"]},
        "launches_slice_5c2": dict(
            {f"terrain from {k} scan (sorted)": v["launches"]
             for k, v in s5c2["files"].items()},
            **{"measured terrain scan (sorted)": s5c2["measured"][
                "scan_launches"],
               "measured terrain pool (sorted)": s5c2["measured"][
                   "launches"]["tile_sweep"],
               "measured terrain value+grad forward": s5c2[
                   "measured_value_grad"]["forward"]["launches"][
                   "tile_sweep"],
               "measured terrain value+grad backward": s5c2[
                   "measured_value_grad"]["backward"]["launches"][
                   "tile_sweep"],
               "lights-and-quadrics box pool (fused)": s5c2["box"][
                   "launches"]["tile_sweep"],
               "lights-and-quadrics box value+grad forward": s5c2[
                   "box_value_grad"]["forward"]["launches"]["tile_sweep"],
               "lights-and-quadrics box value+grad backward": s5c2[
                   "box_value_grad"]["backward"]["launches"][
                   "tile_sweep"]}),
        "launches_slice_6a": slice_6a_launches(s6a, "tile_sweep"),
        "launches_slice_7a": slice_7a_launches(s7a, "tile_sweep"),
        "launches_slice_6b": slice_6b_launches(s6b, "tile_sweep"),
        "launches_slice_6c1": slice_6c1_launches(s6c1, "tile_sweep"),
        "launches_slice_6c2": slice_6c2_launches(s6c2, "tile_sweep"),
        # slice 6e: bench.py's polarized load and the 64^3 one (fused), the
        # pplastic terrain (sorted)
        "launches_slice_6e": slice_6e_launches(s6e, "tile_sweep"),
        # slices 6e-2 and 7b: the stokes value+grads, the native-built
        # terrain, the diffuse and path clones
        "launches_slice_7b": slice_7b_launches(s7b, "tile_sweep"),
        # slice 7c: the sharded large3d pool renders (fused), NCCL and gloo
        "launches_slice_7c": slice_7c_launches(s7c, "tile_sweep"),
        "tiles8_primary": small_loads["terrain(23) primary"],
        "tiles8_incoherent": small_loads["terrain(23) incoherent"],
        "fused_vs_sorted": crossover,
    }]
    for name, src, line in (("tile_bvh", "tile_bvh.cu", 206),
                            ("tile_bvh8", "tile_bvh8.cu", 718)):
        f = bvh_loads[(name, "forest")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"eradiate_kernel_tpu_torch/csrc/{src}",
            "replaces": f"eradiate_kernel_tpu/ops/pallas_intersect.py:{line}",
            "launches": forest_runs[name]["launches"],
            "max_abs_err": max(bvh_loads[(name, load)]["max_abs_err"]
                               for load in ("forest", "terrain primary",
                                            "terrain incoherent")),
            "ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None,
            "load": "2^19 primary rays on the instanced forest",
            "group": intersect.BVH_GROUP,
            "terrain_primary": bvh_loads[(name, "terrain primary")],
            "terrain_incoherent": bvh_loads[(name, "terrain incoherent")],
            "forest_render": forest_runs[name],
            "launches_lane_pool": dict(
                {"forest render": pools[f"forest {name}"]["launches"][name]},
                **({"forest value+grad forward": surface_vg["forest"][
                    "forward"]["launches"][name],
                    "forest value+grad backward": surface_vg["forest"][
                        "backward"]["launches"][name]}
                   if name == "tile_bvh" else {})),
            "launches_measurement": {
                "forest BRF distant 64x64 spp64": measure["forest_brf"][
                    name]["launches"][name]},
            "forest_parallel_nadir_2^18": measure["forest_parallel"][name],
            "launches_slice_5c2": {
                "forest with an OBJ crown 64x64 spp4": s5c2["forest"][
                    name]["launches"]},
            # the forest over its native-built BVH
            "launches_slice_7b": slice_7b_launches(s7b, name),
        })
    # the main path's lookups run the fused trilinear entry (its library
    # call: grid_sample); the gather entry's loads carry index_select
    kernels.append({
        "name": "grid_gather", "route": "cuda",
        "source": "eradiate_kernel_tpu_torch/csrc/grid_gather.cu",
        "replaces": "tools/probe_pallas_gather.py:54",
        "replaces_all": "tools/probe_pallas_gather.py:54,58,62,72 "
                        "(k_fancy, k_take, k_tala, k_onehot via call :87)",
        "launches": atmo["large3d"]["launches"]["grid_gather"],
        "max_abs_err": 0.0, "ms": trilinear["ms"],
        "plain_ms": trilinear["plain_ms"], "bound_ms": trilinear["bound_ms"],
        "bound_by": trilinear["bound_by"],
        "library_ms": trilinear["library_ms"],
        "library_call": "torch.nn.functional.grid_sample (5-D, bilinear, "
                        "border, align_corners=True)",
        "load": "fused trilinear lookup, 64^3 packed table, 32,768 lanes",
        "gather_packed_64^3": gather_loads["packed 64^3"],
        # the measurement path's 64 x 4 x 4 grid (1,024 voxels) takes the
        # einsum lookup: no launch there
        "launches_measurement": {k: v["launches"]["grid_gather"]
                                 for k, v in measure["atmosphere"].items()},
        "gather_probe": gather_loads["probe"],
        # slice 6a: the gather entry on a render path (nearest-filter
        # lookups), the trilinear entry under the ablations
        "launches_slice_6a": slice_6a_launches(s6a, "grid_gather"),
        "launches_slice_7a": slice_7a_launches(s7a, "grid_gather"),
        "launches_slice_6b": slice_6b_launches(s6b, "grid_gather"),
        # slice 6c-1: the chromatic 64^3's lookups, one launch each of the
        # fused entry (sigma_t) and of the gather entry (the srgb albedo's
        # 32-float packed rows)
        "launches_slice_6c1": slice_6c1_launches(s6c1, "grid_gather"),
        "entries_slice_6c1_chromatic_64^3": s6c1["renders"][
            "chromatic 64^3"]["entries"],
        # slice 6c-2: the chromatic 64^3's value+grads (forward and
        # adjoint), each entry = its lookups
        "launches_slice_6c2": slice_6c2_launches(s6c2, "grid_gather"),
        # slice 6e: fused lookups of the 64^3 stokes(volpath) only
        "launches_slice_6e": slice_6e_launches(s6e, "grid_gather"),
        # slice 6e-2: the 64^3 stokes(volpath) value+grad's forward; 7b:
        # the HG clone's 64^3 render
        "launches_slice_7b": slice_7b_launches(s7b, "grid_gather"),
        # slice 7c: the sharded large3d pool renders and the sharded 64^3
        # value+grads' forwards
        "launches_slice_7c": slice_7c_launches(s7c, "grid_gather"),
        "entries_slice_6c2": {k: v["entries"] for k, v in s6c2[
            "value_grads"].items() if "entries" in v},
        "gather_nearest_64^3": s6a["nearest"]["gather_entry"],
        "gather_srgb_32f": s6c1["renders"]["chromatic 64^3"][
            "gather_entry_32f"],
    })
    bwd1 = bwd_loads["C=1"]
    kernels.append({
        "name": "grid_trilinear_bwd", "route": "cuda",
        "source": "eradiate_kernel_tpu_torch/csrc/grid_gather.cu",
        "replaces": "tools/probe_pallas_gather.py:54",
        "replaces_all": "tools/probe_pallas_gather.py:54,58,62,72 (the "
                        "gather probe's kernels; this is the backward "
                        "entry of their port's trilinear lookup)",
        "launches": grads["large3d"]["backward"]["launches"][
            "grid_trilinear_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_loads.values()),
        "ms": bwd1["ms"], "plain_ms": bwd1["plain_ms"],
        "bound_ms": bwd1["bound_ms"], "bound_by": bwd1["bound_by"],
        "library_ms": bwd1["library_ms"],
        "library_call": "torch.autograd.grad of "
                        "torch.nn.functional.grid_sample (5-D, bilinear, "
                        "border, align_corners=True) with respect to the "
                        "unpacked grid",
        "load": "64^3 grid, C = 1, 32,768 lanes of random points",
        "C=3": bwd_loads["C=3"],
        f"C={S37_BANDS}": bwd_loads[f"C={S37_BANDS}"],
        # load B: the adjoint's own lanes (phase 13b)
        "adjoint_loads": bwd_adjoint,
        # the measurement path's gradient (terrain under the gaussian film)
        # looks up no gridvolume
        "launches_measurement": {
            "terrain gaussian value+grad backward": measure[
                "gaussian_value_grad"]["backward"]["launches"][
                "grid_trilinear_bwd"]},
        "launches_slice_6a": slice_6a_launches(s6a, "grid_trilinear_bwd"),
        "launches_slice_6c1": slice_6c1_launches(s6c1, "grid_trilinear_bwd"),
        # slice 6c-2: the chromatic 64^3's adjoint at C = 1 (sigma_t a
        # gridvolume) and C = S37_BANDS (a gridvolume_spectral)
        "launches_slice_6c2": slice_6c2_launches(s6c2, "grid_trilinear_bwd"),
        # slice 6e-2: the 64^3 stokes(volpath) value+grad's backward
        "launches_slice_7b": slice_7b_launches(s7b, "grid_trilinear_bwd"),
        # slice 7c: the sharded 64^3 value+grads' backwards (gloo ranks)
        "launches_slice_7c": slice_7c_launches(s7c, "grid_trilinear_bwd"),
    })
    # the float64 entries (slice 6d, phase 38): launches from phase 38's
    # renders in rgb_double (38c, 38d, 38e), the rest from 38a's loads
    k38 = s6d["kernels"]
    for name, src, replaces, launches, load, prefixes in (
            ("tile_sweep_f64", "tile_sweep.cu",
             "eradiate_kernel_tpu/ops/pallas_intersect.py:94",
             s6d["flagship"]["rgb_double as built"]["launches"],
             "tile_sweep terrain primary", ("tile_sweep",)),
            ("tile_bvh_f64", "tile_bvh.cu",
             "eradiate_kernel_tpu/ops/pallas_intersect.py:206",
             s6d["forest"]["tile_bvh"]["launches"], "tile_bvh forest",
             ("tile_bvh ",)),
            ("tile_bvh8_f64", "tile_bvh8.cu",
             "eradiate_kernel_tpu/ops/pallas_intersect.py:718",
             s6d["forest"]["tile_bvh8"]["launches"], "tile_bvh8 forest",
             ("tile_bvh8",)),
            ("grid_gather_f64", "grid_gather.cu",
             "tools/probe_pallas_gather.py:54",
             s6d["large3d_value_grad"]["kernels"]["lookups"],
             f"grid_gather trilinear {S38_GRID}^3 C=1",
             ("grid_gather gather", "grid_gather trilinear")),
            ("grid_trilinear_bwd_f64", "grid_gather.cu",
             "tools/probe_pallas_gather.py:54",
             s6d["large3d_value_grad"]["backward_launches"],
             f"grid_gather backward {S38_GRID}^3 C=1",
             ("grid_gather backward",))):
        r = k38[load]
        own = {k: v for k, v in k38.items() if k.startswith(prefixes)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"eradiate_kernel_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in own.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "f32_ms": r["f32_ms"],
            "device_us": r["device_us"], "load": load, "loads": own})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"value_grad": grads}))
    print(json.dumps({"atmosphere": {
        k: {kk: vv for kk, vv in v.items() if kk != "launches"}
        for k, v in atmo.items()}}))
    print(json.dumps({"lane_pool": pools, "surface_value_grad": surface_vg,
                      "gates": gates}))
    print(json.dumps({"measurement": measure}))
    print(json.dumps({"materials": materials}))
    print(json.dumps({"slice_5c2": s5c2}))
    print(json.dumps({"slice_6a": s6a}))
    print(json.dumps({"slice_7a": s7a}))
    print(json.dumps({"slice_6b": s6b}))
    print(json.dumps({"slice_6c1": s6c1}))
    print(json.dumps({"slice_6c2": s6c2}))
    print(json.dumps({"slice_6d": s6d}))
    print(json.dumps({"slice_6e": s6e}))
    print(json.dumps({"slice_7b": s7b}))
    print(json.dumps({"slice_7c": s7c}))
    print(json.dumps({"slice_7d": s7d}))
    print(json.dumps({"phase_starts_s": PHASE_STARTS}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
