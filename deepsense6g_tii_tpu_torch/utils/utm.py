"""WGS84 latitude/longitude -> UTM conversion (own copy of
``deepsense6g_tii_tpu/utils/utm.py``, numpy only).

A self-contained, vectorized NumPy implementation of the Snyder/Krueger
series expansion that the third-party ``utm`` package uses, so GPS
normalization is bit-comparable without the dependency.
"""

from __future__ import annotations

import numpy as np

K0 = 0.9996

E = 0.00669438  # WGS84 first eccentricity squared
E2 = E * E
E3 = E2 * E
E_P2 = E / (1 - E)

SQRT_E = np.sqrt(1 - E)
_E = (1 - SQRT_E) / (1 + SQRT_E)

M1 = 1 - E / 4 - 3 * E2 / 64 - 5 * E3 / 256
M2 = 3 * E / 8 + 3 * E2 / 32 + 45 * E3 / 1024
M3 = 15 * E2 / 256 + 45 * E3 / 1024
M4 = 35 * E3 / 3072

R = 6378137  # WGS84 equatorial radius (m)

ZONE_LETTERS = "CDEFGHJKLMNPQRSTUVWXX"


def latlon_to_zone_number(latitude, longitude):
    """UTM zone number, with the Norway / Svalbard exceptions."""
    latitude = np.asarray(latitude, dtype=np.float64)
    longitude = np.asarray(longitude, dtype=np.float64)
    zone = (((longitude + 180.0) / 6.0).astype(np.int64) + 1).clip(1, 60)

    norway = (
        (56 <= latitude) & (latitude < 64) & (3 <= longitude) & (longitude < 12)
    )
    zone = np.where(norway, 32, zone)

    svalbard = (72 <= latitude) & (latitude <= 84) & (longitude >= 0)
    zone = np.where(svalbard & (longitude < 9), 31, zone)
    zone = np.where(svalbard & (9 <= longitude) & (longitude < 21), 33, zone)
    zone = np.where(svalbard & (21 <= longitude) & (longitude < 33), 35, zone)
    zone = np.where(svalbard & (33 <= longitude) & (longitude < 42), 37, zone)
    return zone


def latitude_to_zone_letter(latitude):
    latitude = np.asarray(latitude)
    idx = ((np.clip(latitude, -80, 84) + 80) / 8).astype(np.int64).clip(0, 20)
    if idx.ndim == 0:
        return ZONE_LETTERS[int(idx)]
    return np.array([ZONE_LETTERS[i] for i in idx.ravel()]).reshape(idx.shape)


def zone_number_to_central_longitude(zone_number):
    return (np.asarray(zone_number) - 1) * 6 - 180 + 3


def from_latlon(latitude, longitude):
    """(easting, northing, zone_number, zone_letter) for lat/lon in degrees.

    Accepts scalars or arrays; matches ``utm.from_latlon`` to float64 precision.
    """
    latitude = np.asarray(latitude, dtype=np.float64)
    longitude = np.asarray(longitude, dtype=np.float64)
    if np.any((latitude < -80.0) | (latitude > 84.0)):
        raise ValueError("latitude out of range (must be between 80 deg S and 84 deg N)")
    if np.any((longitude < -180.0) | (longitude > 180.0)):
        raise ValueError("longitude out of range (must be between 180 deg W and 180 deg E)")

    lat_rad = np.radians(latitude)
    lat_sin = np.sin(lat_rad)
    lat_cos = np.cos(lat_rad)

    lat_tan = lat_sin / lat_cos
    lat_tan2 = lat_tan * lat_tan
    lat_tan4 = lat_tan2 * lat_tan2

    zone_number = latlon_to_zone_number(latitude, longitude)
    zone_letter = latitude_to_zone_letter(latitude)

    lon_rad = np.radians(longitude)
    central_lon_rad = np.radians(zone_number_to_central_longitude(zone_number))

    n = R / np.sqrt(1 - E * lat_sin**2)
    c = E_P2 * lat_cos**2

    a = lat_cos * ((lon_rad - central_lon_rad + np.pi) % (2 * np.pi) - np.pi)
    a2 = a * a
    a3 = a2 * a
    a4 = a3 * a
    a5 = a4 * a
    a6 = a5 * a

    m = R * (
        M1 * lat_rad
        - M2 * np.sin(2 * lat_rad)
        + M3 * np.sin(4 * lat_rad)
        - M4 * np.sin(6 * lat_rad)
    )

    easting = (
        K0
        * n
        * (
            a
            + a3 / 6 * (1 - lat_tan2 + c)
            + a5 / 120 * (5 - 18 * lat_tan2 + lat_tan4 + 72 * c - 58 * E_P2)
        )
        + 500000
    )
    northing = K0 * (
        m
        + n
        * lat_tan
        * (
            a2 / 2
            + a4 / 24 * (5 - lat_tan2 + 9 * c + 4 * c**2)
            + a6 / 720 * (61 - 58 * lat_tan2 + lat_tan4 + 600 * c - 330 * E_P2)
        )
    )
    northing = np.where(latitude < 0, northing + 10000000, northing)

    return easting, northing, zone_number, zone_letter


def xy_from_latlong(lat_long: np.ndarray) -> np.ndarray:
    """Rows of (lat, lon) degrees -> rows of (easting, northing)."""
    x, y, *_ = from_latlon(lat_long[:, 0], lat_long[:, 1])
    return np.stack((x, y), axis=1)
