"""Offline preprocessing of a raw DeepSense 6G scenario into the tree the
data path reads (own copies of ``deepsense6g_tii_tpu/data/preprocess/``):
radar FFT maps (``radar.py``, on the card), the LiDAR static-background
filter (``lidar_filter.py``, its nearest-neighbour search on the card or a
k-d tree on the host), the augmentation writers (``augment.py``) and the
index CSVs (``csv_builder.py``).
"""
