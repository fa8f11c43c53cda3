// The tree bias of a fused physics build with FIS_BIAS: gravity and, when
// the Spec asks for it, the velocity-product (Coriolis / centrifugal +
// gyroscopic) term, as partmanip_tpu_torch/sim/dynamics.py:bias_forces
// computes it.  Included by fused_inner_step.cu and fused_inner_step_obj.cu
// after their own headers; only the FIS_BIAS builds call it, so the default
// builds (coriolis off, gravity_scale 0, what every shipped config runs)
// compile to the code they had without it.
//
// It runs at the end of the mass-matrix phase, from the state at the start
// of the inner step (as step_tree computes its bias), on what that phase
// already holds: the link poses and the per-dof world axes and anchors of
// the FK, the link COMs, world inertias and COM Jacobian columns it left in
// scratch.  No second FK.
//
//   v_l = sum_d Jv_ld qd_d,  w_l = sum_d Jw_ld qd_d              (lanes over links)
//   v_anchor_d = sum_f Jv(child(d) origin)_f qd_f,  adot_d = w_child(d) x a_d
//                                                                 (lanes over dofs)
//   jdotv_l = sum_d anc_ld qd_d [rev_d (adot_d x (com_l - p_d) + a_d x (v_l - v_anchor_d))
//                               + pris_d adot_d]
//   jdotw_l = sum_d anc_ld rev_d qd_d adot_d
//   f_l = m_l jdotv_l - m_l g gscale,  t_l = Iw_l jdotw_l + w_l x Iw_l w_l   (lanes over links)
//   bias_d = mask_d sum_l anc_ld (Jv_ld . f_l + Jw_ld . t_l)     (lanes over dofs)
//
// Sums run in the index order, each on one lane, so the result does not
// depend on how many lanes share the phase.

#pragma once

// Scratch floats tree_bias uses after the mass matrix's (NL x 12 + NL x ND
// x 6): v, w, f and t per link, v_anchor and adot per dof.
#define FIS_BIAS_SCRATCH(NL, ND) ((NL) * 12 + (ND) * 6)

// NLANES lanes (16: a half-warp, 32: a warp) with lane indices `lane`; T
// names the tree fields (dof_child, ancestor, mass, dof_mask).  com_w, Iw
// and jv are the mass-matrix phase's [NL][3], [NL][9] and [NL][ND][3];
// ext holds FIS_BIAS_SCRATCH(NL, ND) floats; writes bias[ND].
template <int NL, int ND, class T>
__device__ __forceinline__ void tree_bias(const T& t, const float (*lp)[3], const float (*axw)[3],
                                          const float (*anw)[3], const float* rev,
                                          const float* pris, const float* qv, const float* com_w,
                                          const float* Iw, const float* jv, float* ext,
                                          float* bias, float gravity, float gscale, bool coriolis,
                                          int lane) {
    float* vl = ext;                          // [NL][3] link COM velocities
    float* wl = vl + NL * 3;                  // [NL][3] link angular velocities
    float* fl = wl + NL * 3;                  // [NL][3] force per link
    float* tl = fl + NL * 3;                  // [NL][3] torque per link
    float* va = tl + NL * 3;                  // [ND][3] anchor velocities
    float* ad = va + ND * 3;                  // [ND][3] axis rates
    if (coriolis) {
        if (lane < NL) {
            const int l = lane;
            V3 v = v3(0.0f, 0.0f, 0.0f), w = v3(0.0f, 0.0f, 0.0f);
            for (int d = 0; d < ND; ++d) {
                const float a = t.ancestor[l][d];
                v = v + ld3(jv + 3 * (l * ND + d)) * qv[d];
                w = w + (ld3(axw[d]) * (rev[d] * a)) * qv[d];
            }
            st3(vl + 3 * l, v);
            st3(wl + 3 * l, w);
        }
        __syncwarp();
        if (lane < ND) {
            const int d = lane, c = t.dof_child[d];
            const V3 pc = ld3(lp[c]);
            V3 v = v3(0.0f, 0.0f, 0.0f);
            for (int f = 0; f < ND; ++f) {
                const V3 ax = ld3(axw[f]);
                const V3 col = (cross(ax, pc - ld3(anw[f])) * rev[f] + ax * pris[f])
                             * t.ancestor[c][f];
                v = v + col * qv[f];
            }
            st3(va + 3 * d, v);
            st3(ad + 3 * d, cross(ld3(wl + 3 * c), ld3(axw[d])));
        }
        __syncwarp();
    }
    if (lane < NL) {
        const int l = lane;
        const float m = t.mass[l];
        V3 f = v3(0.0f, 0.0f, -((m * gravity) * gscale));
        V3 tq = v3(0.0f, 0.0f, 0.0f);
        if (coriolis) {
            const V3 cw = ld3(com_w + 3 * l), v = ld3(vl + 3 * l), w = ld3(wl + 3 * l);
            V3 jdv = v3(0.0f, 0.0f, 0.0f), jdw = v3(0.0f, 0.0f, 0.0f);
            for (int d = 0; d < ND; ++d) {
                if (t.ancestor[l][d] == 0.0f) continue;
                const V3 adot = ld3(ad + 3 * d), ax = ld3(axw[d]);
                const V3 col = (cross(adot, cw - ld3(anw[d])) + cross(ax, v - ld3(va + 3 * d)))
                             * rev[d] + adot * pris[d];
                jdv = jdv + col * qv[d];
                jdw = jdw + adot * (rev[d] * qv[d]);
            }
            const float* I = Iw + 9 * l;
            f = f + jdv * m;
            tq = matvec(I, jdw) + cross(w, matvec(I, w));
        }
        st3(fl + 3 * l, f);
        st3(tl + 3 * l, tq);
    }
    __syncwarp();
    if (lane < ND) {
        const int d = lane;
        const V3 ax = ld3(axw[d]);
        float b = 0.0f;
        for (int l = 0; l < NL; ++l) {
            const float a = t.ancestor[l][d];
            if (a == 0.0f) continue;
            b += dot(ld3(jv + 3 * (l * ND + d)), ld3(fl + 3 * l))
               + dot(ax * (rev[d] * a), ld3(tl + 3 * l));
        }
        bias[d] = b * t.dof_mask[d];
    }
    __syncwarp();
}
