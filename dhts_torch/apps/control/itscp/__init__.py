"""ITSCP: intersection signal control on an N x N grid."""
