"""Plain PyTorch references of what a benchmark evaluation computes: the HOD
population of LRGs, ELGs and QSOs (``hod.py``), the TSC mesh, its Fourier
transform and the binned auto and cross spectra with their Legendre poles
(``mesh.py``), and xi(rp, pi) from pair counts (``pairs.py``).

They follow the published definitions (Zheng et al. 2005, Alam et al. 2020,
Yuan et al. 2022 for the occupations; Hockney & Eastwood for TSC), import
nothing but torch and numpy, and compute in float64 unless asked for a lower
precision: ``Precision('bf16')`` rounds every input and every stage's result
to bfloat16, the control that a comparison must tell apart from the program.
"""
